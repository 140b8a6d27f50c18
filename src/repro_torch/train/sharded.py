"""The sharded step on a ``DeviceMesh`` (port of the reference's
``jax.jit(step, in_shardings=tree_shardings(...))``).

``make_sharded_step(arch, shape, mesh)`` places the step's arguments by
``distributed/sharding.py::tree_shardings(*step_arg_specs(arch, shape),
mesh)``: each rank holds only its own shard of every parameter and of the
optimizer state (``place``; ``local_bytes`` of its ``LeafSharding``s), and
its block of the batch (``shard_batch``). The step is ``configs/base.py``'s
(microbatch accumulation included) run as explicit SPMD
(``distributed/spmd.py``):

  * the parameters are all-gathered where the model uses them (an LM one
    layer at a time, again in the layer's recomputation; the other models
    at the top of the loss), and the backward of that gather
    reduce-scatters each gradient to its shard, summed over every rank
    that used it: the FSDP pattern;
  * the model runs under ``use_mesh(mesh)`` on the rank's block: a graph's
    nodes and edges in N blocks (N the mesh size), an LM's rows over the
    batch axes and its sequence over the model axis, DIEN's rows over all
    N, the retrieval's candidates over all N; the loss is the rank's share
    of the global loss, and what crosses blocks is exchanged by the model
    code (``owner_gather_scatter``, the attention's key/value gather, the
    MoE's routing counts, the pooled graph sums);
  * the global norm sums every shard's squares once, and the AdamW update
    runs on the shards (a factored statistic's means reduced over the
    ranks that split the parameter's dimension).

A batch whose rows, sequence, nodes or edges do not divide over the mesh
runs whole on every rank (``mode == "replicated"``): the parameters are
still sharded and gathered, the model runs without a mesh, and each rank's
share of the loss is 1/N of it. The losses and updated parameters are the
unsharded step's up to the order of float sums; the metrics are summed over
the ranks (the grad norm is global already).

The GNN's adjacency build (a fixed-size CSR: no host read) and the ELL
kernels run on each rank's own tensors; the dry-run (``launch/dryrun.py``)
traces this step on meta tensors over a fake process group, the GNNs'
included.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import (Arch, Shape, make_step,
                                      make_train_step, param_builders,
                                      step_arg_specs)
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (_tensor_leaves, axis_sizes,
                                              tree_shardings, use_mesh)
from repro_torch.optim.adamw import adamw_update

_LM = ("lm-dense", "lm-moe")


def _rows(n: int, k: int, parts: int, part: int, device) -> torch.Tensor:
    """Row ids of ``part`` of ``parts``: of each of the k microbatches of an
    n-row batch, its ``part``-th block, so that the rank's microbatch i is
    the global microbatch i's block."""
    per = n // (k * parts)
    base = torch.arange(k, device=device)[:, None] * (n // k) + part * per
    return (base + torch.arange(per, device=device)).reshape(-1)


def shard_of(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's shard of a whole tensor (DTensor ``placements``; a dim
    sharded over several axes splits over them in mesh order)."""
    sizes = list(axis_sizes(mesh).values())
    coord = mesh.get_coordinate()
    x = full
    for a, p in enumerate(placements):
        if p.is_shard():
            x = x.chunk(sizes[a], dim=p.dim)[coord[a]]
    return x.clone() if x is not full else x


class ShardedStep:
    """``make_step(arch, shape)`` on ``mesh``; call it as the unsharded
    step, on shards (``place``) and a batch block (``shard_batch``)."""

    def __init__(self, arch: Arch, shape: Shape, mesh):
        self.arch, self.shape, self.mesh = arch, shape, mesh
        self.sp = spmd.split(mesh)
        args, specs = step_arg_specs(arch, shape)
        self.shardings = tree_shardings(args, specs, mesh)
        self.full_shapes = {p: (tuple(t.shape), t.dtype)
                            for p, t in _leaves(args)}
        self.param_placements = {n: self.shardings[f"0.{n}"].placements
                                 for n in args[0]}
        # how ``shard_batch`` split the last batch
        self.mode = "split"
        _, loss_fn = param_builders(arch, shape)
        self._loss_fn = loss_fn
        if shape.kind == "train":
            self._check_factored(args[0])
            self._step = make_train_step(arch, self._share,
                                         self._global_norm, self._update)
        else:
            self._step = make_step(arch, shape)

    # ------------------------------------------------------------ layout
    def divides(self, batch) -> bool:
        """Whether ``batch`` (whole) splits over the mesh: an LM's rows over
        the microbatches and the batch axes and its sequence over the model
        axis; a graph's nodes and edges, DIEN's rows over the microbatches
        and all ranks, the retrieval's candidates over all ranks."""
        sp, kind, fam = self.sp, self.shape.kind, self.arch.family
        k = max(1, self.arch.microbatches) if kind == "train" else 1
        if fam == "gnn":
            return (batch.feats.shape[0] % sp.n == 0
                    and batch.senders.shape[0] % sp.n == 0)
        if fam in _LM:
            if kind == "decode":
                rows, seq = batch["token"].shape[0], batch["cache_k"].shape[2]
            else:
                rows, seq = batch["tokens"].shape
            return rows % (k * sp.data) == 0 and seq % sp.model == 0
        if kind == "retrieval":
            return batch["candidate_ids"].shape[0] % sp.n == 0
        return batch["target_item"].shape[0] % (k * sp.n) == 0

    @property
    def local_bytes(self) -> int:
        """Bytes of this rank's shards of the parameters and the optimizer
        state (``LeafSharding.local_bytes`` summed)."""
        return sum(s.local_bytes for p, s in self.shardings.items()
                   if p.startswith(("0.", "1.")))

    def place(self, params: dict, opt_state: dict | None = None):
        """This rank's shards of whole parameters (and optimizer state)."""
        out = {n: shard_of(t, self.param_placements[n], self.mesh)
               for n, t in params.items()}
        if opt_state is None:
            return out
        return out, _map_tree(opt_state, "1", lambda p, t: shard_of(
            t, self.shardings[p].placements, self.mesh))

    @torch.no_grad()
    def gather(self, params: dict, opt_state: dict | None = None):
        """The whole tensors from this rank's shards (every rank of the
        mesh calls it)."""
        out = {n: spmd.gather_param(t, self.param_placements[n], self.mesh)
               for n, t in params.items()}
        if opt_state is None:
            return out
        return out, _map_tree(opt_state, "1", lambda p, t: spmd.gather_param(
            t, self.shardings[p].placements, self.mesh))

    def whole_like(self, params: dict, opt_state: dict):
        """Meta tensors of the whole shapes and dtypes of the shards'
        tensors (a checkpoint's restore template)."""
        def like(path, _):
            shape, dtype = self.full_shapes[path]
            return torch.empty(shape, dtype=dtype, device="meta")
        return (_map_tree(params, "0", like), _map_tree(opt_state, "1", like))

    def shard_batch(self, batch):
        """This rank's block of a whole batch (copied: it holds none of the
        whole batch's storage), or the batch itself when it does not
        divide (``mode`` "replicated" until the next call)."""
        self.mode = "split" if self.divides(batch) else "replicated"
        if self.mode == "replicated":
            return batch
        sp, kind, fam = self.sp, self.shape.kind, self.arch.family
        if fam == "gnn":
            return _graph_block(batch, sp.n, sp.rank)
        if kind == "retrieval":
            out = dict(batch)
            out["candidate_ids"] = batch["candidate_ids"].chunk(
                sp.n)[sp.rank].clone()
            return out
        k = max(1, self.arch.microbatches) if kind == "train" else 1
        first = next(iter(batch.values()))
        dev = first.device
        if fam in _LM:
            rows = _rows(batch["token" if kind == "decode" else "tokens"]
                         .shape[0], k, sp.data, sp.data_index, dev)
            out = {}
            for key, v in batch.items():
                if key in ("cache_k", "cache_v"):
                    v = v.index_select(1, rows)
                    v = v.chunk(sp.model, dim=2)[sp.model_index].clone()
                elif v.dim() > 0:
                    v = v.index_select(0, rows)
                out[key] = v
            return out
        rows = _rows(first.shape[0], k, sp.n, sp.rank, dev)
        return {key: v.index_select(0, rows) for key, v in batch.items()}

    # ------------------------------------------------------------- model
    @contextlib.contextmanager
    def _context(self):
        """The shards' placements for ``spmd.full``, and the mesh ambient
        under ``split`` (also through the backward, whose recomputed layers
        gather again)."""
        with spmd.param_shards(self.param_placements, self.mesh), \
                use_mesh(self.mesh if self.mode == "split" else None):
            yield

    def _run(self, fn: Callable, params: dict, *rest):
        if self.arch.family not in _LM:
            params = {n: spmd.full(n, t) for n, t in params.items()}
        return fn(params, *rest)

    def _share(self, params: dict, batch):
        """This rank's share of the loss and of its metrics."""
        loss, metrics = self._run(self._loss_fn, params, batch)
        if self.mode == "replicated":
            loss = loss / self.sp.n
            metrics = {n: v / self.sp.n for n, v in metrics.items()}
        return loss, metrics

    def _global_norm(self, grads: dict) -> torch.Tensor:
        """Every element's square counted once over the shards."""
        sizes = axis_sizes(self.mesh)
        parts = []
        for n, g in grads.items():
            copies = math.prod(s for s, p in zip(sizes.values(),
                                                  self.param_placements[n])
                               if not p.is_shard())
            parts.append(torch.sum(torch.square(g.to(torch.float32)))
                         / copies)
        return torch.sqrt(spmd.global_sum(torch.sum(torch.stack(parts)),
                                          self.mesh))

    def _mean(self, x: torch.Tensor, dim: int, param_dim: int, name: str):
        """``adamw_update``'s mean over parameter ``name``'s ``param_dim``:
        the shards' sums summed over the axes that split that dim."""
        shape = self.full_shapes[f"0.{name}"][0]
        axes = [a for a, p in enumerate(self.param_placements[name])
                if p.is_shard() and p.dim == param_dim % len(shape)]
        if not axes:
            return x.mean(dim=dim)
        return (spmd.axes_sum(x.sum(dim=dim), self.mesh, axes)
                / shape[param_dim])

    def _update(self, params, grads, state, cfg):
        return adamw_update(params, grads, state, cfg, mean=self._mean)

    def _check_factored(self, params: dict) -> None:
        """A factored statistic's shard must line up with its parameter's:
        the row statistic split as the parameter's rows, the column
        statistic as its columns."""
        for n, t in params.items():
            pl = self.param_placements[n]
            for stat, drop in (("vr", t.dim() - 1), ("vc", t.dim() - 2)):
                got = self.shardings.get(f"1.per_param.{n}.{stat}")
                want = tuple(
                    Replicate() if not p.is_shard() or p.dim == drop
                    else Shard(p.dim - (p.dim > drop)) for p in pl)
                if got is not None and got.placements != want:
                    raise NotImplementedError(
                        f"{n}.{stat}: placements {got.placements} do not "
                        f"follow the parameter's {pl}")

    # -------------------------------------------------------------- call
    def __call__(self, params, *rest):
        """The step on shards: (params, opt_state, batch) -> (params,
        opt_state, metrics) for a train step, else (params, batch) -> the
        step's output (this rank's block of it under ``split``)."""
        if self.shape.kind == "train":
            opt_state, batch = rest
            with self._context():
                params, opt_state, metrics = self._step(params, opt_state,
                                                        batch)
            metrics = {n: v if n == "grad_norm"
                       else spmd.global_sum(v, self.mesh)
                       for n, v in metrics.items()}
            return params, opt_state, metrics
        with self._context():
            out = self._run(self._step, params, *rest)
        if self.arch.family == "gnn" and self.mode == "split":
            out = {n: spmd.global_sum(v, self.mesh) for n, v in out.items()}
        return out


make_sharded_step = ShardedStep


def _leaves(tree):
    """(dotted path, tensor) of a nest of dicts and dataclasses, as
    ``tree_shardings`` names them."""
    for path, t in _tensor_leaves(tree):
        yield ".".join(map(str, path)), t


def _map_tree(tree, prefix: str, fn: Callable):
    if isinstance(tree, dict):
        return {k: _map_tree(v, f"{prefix}.{k}", fn) for k, v in tree.items()}
    return fn(prefix, tree)


def _graph_block(gb, n: int, r: int):
    """Block ``r`` of ``n`` of a ``GraphBatch``'s nodes and of its edges."""
    edge = ("senders", "receivers", "edge_mask")
    node = ("feats", "pos", "labels", "node_mask", "graph_ids")
    return gb._replace(**{f: getattr(gb, f).chunk(n)[r].clone()
                          for f in edge + node})
