"""Roofline terms for the dry-run, on NVIDIA H100 SXM 80GB constants (port
of ``repro/launch/roofline.py``).

Three terms per cell, in seconds, per device:

  compute    = flops      / 989e12 dense bfloat16 FLOP/s
  memory     = hbm_bytes  / 3.35e12 B/s
  collective = wire_bytes / link bytes/s: 450e9 over NVLink for a group
               inside one 8-GPU node, 50e9 (one 400 Gb/s NIC a GPU) for
               a group that spans nodes

Collective wire bytes follow the reference's ring estimates (``R`` the
result bytes, ``k`` the group size), ``wire_bytes``:

  all-gather       R*(k-1)/k
  all-reduce       2*R*(k-1)/k
  reduce-scatter   R*(k-1)        (result is the per-shard output)
  all-to-all       R*(k-1)/k
  collective-permute  R

The reference reads its numbers off XLA's compiled module (cost analysis,
memory analysis, post-SPMD HLO). Here ``CountingMode`` counts them over
one traced step instead, a ``TorchDispatchMode`` over every aten and c10d
op it runs, best on meta tensors under a fake process group
(``launch/mesh.py::fake_process_group``) where nothing is allocated or
sent:

  FLOPs       ``torch.utils.flop_counter``'s formulas (products and
              attention; elementwise ops count none);
  HBM bytes   the reference's model: every op writes its outputs and reads
              its inputs, a view writes nothing, an in-place op writes the
              tensor it mutates (a slice only the slice) and reads the rest;
  collectives every c10d op and every functional collective
              (``_c10d_functional``: what DTensor and the sharded step
              dispatch; ``wait_tensor`` moves nothing): its kind, result
              bytes and group size;
  peak live   the most bytes of storage alive at once, the tensors held
              when counting starts (``hold``) included.

A Python loop runs its trips for real, so no trip count is recovered. A
kernel wrapper given meta tensors runs its custom op's fake (meta)
implementation, which counts as the kernel: one read of its inputs, one
write of its outputs and the FLOPs of the formula registered for it, if
any (``kernels`` keeps each kernel's ops and FLOPs). An op whose result
the host reads or whose output shape depends on tensor values cannot run
on meta tensors: it raises ``DataDependentOp``.
"""
from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM 80GB (sources in PERF.md)
PEAK_FLOPS = 989e12       # dense bfloat16 FLOP/s
HBM_BW = 3.35e12          # B/s
NVLINK_BW = 450e9         # B/s a direction, inside one 8-GPU node
INTER_NODE_BW = 50e9      # B/s a direction, one 400 Gb/s NIC a GPU
GPUS_PER_NODE = 8


def wire_bytes(op: str, result_bytes: float, k: int) -> float:
    """Ring-algorithm bytes one device sends for collective ``op`` whose
    result is ``result_bytes`` over a group of ``k``."""
    k = max(k, 1)
    if op == "all-gather":
        return result_bytes * (k - 1) / k
    if op == "all-reduce":
        return 2 * result_bytes * (k - 1) / k
    if op == "reduce-scatter":
        return result_bytes * (k - 1)
    if op == "all-to-all":
        return result_bytes * (k - 1) / k
    if op == "collective-permute":
        return result_bytes
    raise ValueError(op)


def group_link_bw(ranks) -> float:
    """NVLink for a group inside one node (consecutive ranks fill a node),
    the NIC for one that spans nodes."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else INTER_NODE_BW


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0                 # per-device, ring estimate
    seconds: float = 0.0                    # wire bytes over each link
    count: int = 0
    by_op: dict = field(default_factory=dict)

    def add(self, op: str, wire: float, link_bw: float):
        self.wire_bytes += wire
        self.seconds += wire / link_bw
        self.count += 1
        d = self.by_op.setdefault(op, dict(wire_bytes=0.0, count=0))
        d["wire_bytes"] += wire
        d["count"] += 1


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   wire_bytes_per_dev: float,
                   collective_s: float | None = None) -> dict:
    """The three terms, the dominant one, the step-time bound and the
    roofline fraction (compute over the bound). ``collective_s`` defaults
    to the wire bytes over the inter-node link."""
    compute = flops_per_dev / PEAK_FLOPS
    memory = hbm_bytes_per_dev / HBM_BW
    collective = (wire_bytes_per_dev / INTER_NODE_BW
                  if collective_s is None else collective_s)
    terms = dict(compute_s=compute, memory_s=memory, collective_s=collective)
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update(
        dominant=dom.replace("_s", ""),
        step_time_bound_s=bound,
        # fraction of the bound that is useful compute = roofline fraction
        roofline_fraction=(compute / bound) if bound > 0 else 0.0,
    )
    return terms


class DataDependentOp(RuntimeError):
    """The traced step ran an op that needs tensor values (a host read, an
    output shape that depends on the data)."""


aten = torch.ops.aten
_HOST_READS = (aten._local_scalar_dense.default,)
# allocation without a write
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}
# functional collective (``_c10d_functional``, what DTensor and
# ``torch.distributed._functional_collectives`` dispatch) -> its kind; the
# result is the op's output, the input its first argument. The namespace's
# other ops (``wait_tensor``) hand their input back: no collective and no
# bytes.
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_to_all_single": "all-to-all",
               "broadcast": "all-gather"}
# c10d op -> (kind, index of its result arg, index of its input arg)
_C10D = {"allreduce_": ("all-reduce", 0, 0),
         "_allgather_base_": ("all-gather", 0, 1),
         "allgather_": ("all-gather", 0, 1),
         "allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
         "_reduce_scatter_base_": ("reduce-scatter", 0, 1),
         "reduce_scatter_": ("reduce-scatter", 0, 1),
         "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
         "alltoall_base_": ("all-to-all", 0, 1),
         "alltoall_": ("all-to-all", 0, 1)}


def _tensors(x, out=None) -> list:
    """The tensors in a nest of tuples, lists, dicts and dataclasses (a
    ``GraphBatch``)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _process_group(args):
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:    # a ReduceOp or another script object
                continue
    raise ValueError("a c10d op without a process group")


def _named_group(args):
    """A functional collective's group: its last string argument names
    it."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name)


class _OpInfo:
    """What the counting needs of one op overload, read once."""

    def __init__(self, func):
        packet = func._overloadpacket
        self.c10d = func.namespace == "c10d"
        self.functional = (_FUNCTIONAL.get(packet.__name__)
                           if func.namespace == "_c10d_functional" else None)
        # wait_tensor, _wrap_tensor_autograd: the input handed back
        self.alias = (func.namespace == "_c10d_functional"
                      and self.functional is None)
        self.flops = flop_registry.get(packet)
        # a port kernel's custom op (``repro_torch::<kernel>``)
        self.kernel = (packet.__name__ if func.namespace == "repro_torch"
                       else None)
        self.view = func.is_view or packet.__name__ in _NO_WRITE
        self.composite = (self.flops is None and not self.c10d
                          and func.namespace != "_c10d_functional"
                          and func.has_kernel_for_dispatch_key(
                              torch._C.DispatchKey.CompositeImplicitAutograd))
        names = [a.name for a in func._schema.arguments]
        self.names = names
        self.mutated = [i for i, a in enumerate(func._schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write]


class CountingMode(TorchDispatchMode):
    """Counts one traced region (see the module docstring): ``flops``,
    ``hbm_bytes``, ``collectives`` (a ``CollectiveStats``), ``peak_bytes``,
    ``ops`` and ``kernels`` ({kernel: {"ops", "flops"}} of the port
    kernels' custom ops). Not reentrant: one trace a mode."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.collectives = CollectiveStats()
        self.peak_bytes = 0
        self.live_bytes = 0
        self._live: set[int] = set()
        self._info: dict = {}

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments, which its caller holds throughout)."""
        for t in _tensors(tree):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()     # one Python object a storage, kept
        key = s._cdata              # alive while the storage lives
        if key in self._live:
            return
        n = s.nbytes()
        self._live.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key, n).atexit = False

    def _free(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def _collective(self, func, args) -> None:
        kind, res_i, in_i = _C10D[func._overloadpacket.__name__]
        pg = _process_group(args)
        result = _nbytes(_tensors(args[res_i]))
        self.collectives.add(kind, wire_bytes(kind, result, pg.size()),
                             group_link_bw(dist.get_process_group_ranks(pg)))
        self.hbm_bytes += result + _nbytes(_tensors(args[in_i]))

    def _functional(self, kind: str, args, out) -> None:
        pg = _named_group(args)
        result = _nbytes(_tensors(out))
        self.collectives.add(kind, wire_bytes(kind, result, pg.size()),
                             group_link_bw(dist.get_process_group_ranks(pg)))
        self.hbm_bytes += result + _nbytes(_tensors(args[0]))
        for t in _tensors(out):
            self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise DataDependentOp(f"{func} (a host read of a tensor value)")
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo(func)
        if info.composite:
            # a composite op reaches the mode whole under inference mode:
            # count its parts, as autograd would have handed them over
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        try:
            out = func(*args, **kwargs)
        except NotImplementedError as e:
            if not any(t.is_meta for t in _tensors((args, kwargs))):
                raise
            raise DataDependentOp(f"{func} (no meta kernel: its output "
                                  f"shape depends on the data)") from e
        self.ops += 1
        if info.c10d:
            self._collective(func, args)
            return out
        if info.functional:
            self._functional(info.functional, args, out)
            return out
        if info.alias:
            return out
        flops = (0 if info.flops is None
                 else info.flops(*args, **kwargs, out_val=out))
        self.flops += flops
        if info.kernel:
            k = self.kernels.setdefault(info.kernel, dict(ops=0, flops=0))
            k["ops"] += 1
            k["flops"] += flops
        if info.view:
            for t in _tensors(out):
                self._track(t)
            return out
        ins = _tensors((args, kwargs))
        if info.mutated:
            named = dict(zip(info.names, args))
            named.update(kwargs)
            written = _tensors([named.get(info.names[i])
                                for i in info.mutated])
            keys = {id(t) for t in written}
            self.hbm_bytes += _nbytes(written) + _nbytes(
                t for t in ins if id(t) not in keys)
            return out
        in_keys = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in _tensors(out)
                 if t.untyped_storage()._cdata not in in_keys]
        if fresh:                 # an op whose outputs alias no input
            self.hbm_bytes += _nbytes(fresh) + _nbytes(ins)
        for t in fresh:
            self._track(t)
        return out
