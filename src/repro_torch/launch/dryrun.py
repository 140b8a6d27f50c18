"""Dry-run of every (arch x shape) cell on the production meshes (port of
``repro/launch/dryrun.py``), with no device touched and nothing allocated:
the step's arguments are meta tensors (``configs/base.py::
step_arg_specs``) and the mesh is a ``DeviceMesh`` over a fake process
group of 256 or 512 ranks, which ``main`` starts for each mesh (the
counterpart of the reference's fake host devices).

Each model cell records:
  * the arguments' bytes on one device, their logical specs resolved onto
    the mesh (``distributed/sharding.py``), and the bytes a donated
    argument gives back (``alias_bytes``: params and optimizer state of a
    train step, the cache of a decode step);
  * ``model_flops_global`` and ``executed_flops_global``
    (``launch/flops.py``);
  * the sharded step (``train/sharded.py``) traced on rank 0's meta
    shards and batch block over the fake group under
    ``launch/roofline.py::CountingMode``: per device its counted FLOPs,
    HBM bytes, collectives (wire bytes, count and ``by_op``, the
    reference's keys, and their seconds over NVLink inside a node and the
    NIC across nodes), the bytes of its outputs and its temporaries (the
    peak of live storage less the traced arguments), and the roofline
    terms: compute from the larger of the counted and the executed FLOPs a
    device, memory from the HBM bytes, collective from the wire seconds.
    An LM of more than 3 layers is traced at 2 and 3 layers and every
    count, the peak included, taken at its layer count (its layers are
    alike and each is gathered, run and freed alike, so the counts are
    affine in the layer count; ``sharded.rule`` says so);
  * ``counted_flops_global``: ``CountingMode`` over the unsharded step
    at the global shapes (a decode step given its cache length as a host
    int, which it reads on the host), the same affine rule at 1 and 2
    layers.

The GCN and GIN steps trace like the others: their adjacency is a
fixed-size CSR (``core/csr.py::from_edge_tensors``) and their aggregation
kernels run as custom ops on meta tensors, each counted as one op with
the FLOPs of its registered formula (``counted_kernel_flops`` names the
rule: ``ell_spmm`` 2 * n * k_max * d, ``spmm_residue`` 2 * m * d, upper
bounds). A cell whose step needs tensor values (an op ``CountingMode``
raises ``DataDependentOp`` on) is ``status: "skipped"`` with a
``skip_reason`` naming that op, beside the fields above; no cell of the
registry does today, so the only skipped cells are the shapes the
reference skips, which keep its reason. A cell that raises is recorded as
``"error"`` and the run exits nonzero.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      [--out artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import (get_arch, list_archs, make_step,
                                      step_arg_specs)
from repro_torch.distributed.sharding import tree_shardings
from repro_torch.kernels.ell_spmm.ops import slab_flops
from repro_torch.kernels.spmm_residue.ops import residue_flops
from repro_torch.launch import roofline as rl
from repro_torch.launch.bfs_dryrun import DEFAULT_OUT
from repro_torch.launch.flops import analytic_flops
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.train.sharded import make_sharded_step

_LM = ("lm-dense", "lm-moe")
# the FLOP formula registered for each kernel's custom op, whose rule the
# record states
KERNEL_FLOP_RULES = {"ell_spmm": slab_flops, "spmm_residue": residue_flops}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _count(arch, shape) -> dict:
    args, _ = step_arg_specs(arch, shape)
    if shape.kind == "decode":       # the step reads cache_len on the host
        args[1]["cache_len"] = shape.dims["seq_len"] - 1
    step = make_step(arch, shape)
    with rl.CountingMode() as cm:
        cm.hold(args)
        step(*args)
    return dict(flops=cm.flops, hbm_bytes=cm.hbm_bytes,
                peak_bytes=cm.peak_bytes, ops=cm.ops, kernels=cm.kernels)


def kernel_flops(kernels: dict) -> dict:
    """``CountingMode.kernels`` with each kernel's FLOP rule."""
    return {k: dict(v, rule=" ".join(KERNEL_FLOP_RULES[k].__doc__.split()))
            for k, v in kernels.items()}


def counted_step(arch, shape) -> dict:
    """The counting mode over one unsharded step on meta tensors at the
    global shapes. An LM is traced at 1 and 2 layers and its counts taken
    at its layer count: its layers are alike, so the counts are affine in
    the layer count (the peak is not, and is left out)."""
    t0 = time.time()
    try:
        if arch.family in ("lm-dense", "lm-moe") \
                and arch.model_cfg.n_layers > 2:
            one, two = (_count(dataclasses.replace(
                arch, model_cfg=dataclasses.replace(arch.model_cfg,
                                                    n_layers=k)), shape)
                        for k in (1, 2))
            extra = arch.model_cfg.n_layers - 1
            c = {k: one[k] + extra * (two[k] - one[k])
                 for k in ("flops", "hbm_bytes", "ops")}
            c["peak_bytes"] = None
            rule = "traced at 1 and 2 layers, affine in the layer count"
        else:
            c = _count(arch, shape)
            rule = "traced whole"
    except rl.DataDependentOp as e:
        return dict(counted_flops_global=None,
                    counted_skip_reason=f"the step runs {e}, which meta "
                                        f"tensors cannot give")
    out = dict(counted_flops_global=c["flops"],
               counted_hbm_bytes_global=c["hbm_bytes"],
               counted_peak_bytes_global=c["peak_bytes"],
               counted_ops=c["ops"], counted_rule=rule,
               trace_s=round(time.time() - t0, 2))
    if c.get("kernels"):
        out["counted_kernel_flops"] = kernel_flops(c["kernels"])
    return out


def _layers(arch, k: int):
    return dataclasses.replace(arch, model_cfg=dataclasses.replace(
        arch.model_cfg, n_layers=k))


def _trace_sharded(arch, shape, mesh) -> dict:
    """One sharded step on rank 0's meta shards under ``CountingMode``."""
    args, _ = step_arg_specs(arch, shape)
    step = make_sharded_step(arch, shape, mesh)
    batch = step.shard_batch(args[-1])
    if shape.kind == "decode":       # the step reads cache_len on the host
        batch["cache_len"] = shape.dims["seq_len"] - 1
    if shape.kind == "train":
        call = (*step.place(args[0], args[1]), batch)
    else:
        call = (step.place(args[0]), batch)
    with rl.CountingMode() as cm:
        cm.hold(call)
        held = cm.live_bytes
        out = step(*call)
    c = cm.collectives
    return dict(flops=cm.flops, hbm=cm.hbm_bytes, peak=cm.peak_bytes,
                held=held, output=rl._nbytes(rl._tensors(out)),
                wire=c.wire_bytes, seconds=c.seconds, count=c.count,
                by_op={k: dict(v) for k, v in c.by_op.items()},
                mode=step.mode)


def sharded_terms(arch, shape, mesh) -> dict:
    """``_trace_sharded``, an LM of more than 3 layers at 2 and 3 layers
    and taken affinely at its layer count."""
    t0 = time.time()
    n = arch.model_cfg.n_layers if arch.family in _LM else 0
    if n > 3:
        two, three = (_trace_sharded(_layers(arch, k), shape, mesh)
                      for k in (2, 3))

        def at(a, b):
            return a + (n - 2) * (b - a)
        t = {k: at(two[k], three[k]) if isinstance(two[k], (int, float))
             else two[k] for k in two}
        t["by_op"] = {op: {k: at(v[k], three["by_op"][op][k])
                           for k in v} for op, v in two["by_op"].items()}
        rule = "traced at 2 and 3 layers, affine in the layer count"
    else:
        t = _trace_sharded(arch, shape, mesh)
        rule = "traced whole"
    t.update(rule=rule, trace_s=round(time.time() - t0, 2))
    return t


def mesh_record(arch, shape, multi_pod: bool, donate: bool = True) -> dict:
    """A cell's record without its counted fields, on the production mesh
    over the process group the caller started."""
    rec = dict(arch=arch.arch_id, shape=shape.shape_id,
               mesh=_mesh_tag(multi_pod), kind=shape.kind)
    if shape.skip_reason:
        rec.update(status="skipped", skip_reason=shape.skip_reason)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.mesh.numel()
    args, specs = step_arg_specs(arch, shape)
    shardings = tree_shardings(args, specs, mesh)
    # donated: params and optimizer state of a train step, the cache
    # buffers of a decode step (updated in place)
    donated = {"train": ("0.", "1."),
               "decode": ("1.cache_k", "1.cache_v")}.get(shape.kind, ())
    alias = sum(s.local_bytes for p, s in shardings.items()
                if donate and p.startswith(donated))
    an = analytic_flops(arch, shape)
    exec_per_dev = an["executed_flops"] / n_dev
    rec.update(
        n_devices=n_dev, donate=donate,
        model_flops_global=an["model_flops"],
        executed_flops_global=an["executed_flops"],
        executed_flops_per_device=exec_per_dev,
        memory=dict(argument_bytes=sum(s.local_bytes
                                       for s in shardings.values()),
                    alias_bytes=alias, output_bytes=None, temp_bytes=None),
    )
    try:
        t = sharded_terms(arch, shape, mesh)
    except rl.DataDependentOp as e:
        rec.update(status="skipped",
                   skip_reason=f"the sharded step runs {e}, which meta "
                               f"tensors cannot give",
                   roofline=dict(compute_s=exec_per_dev / rl.PEAK_FLOPS,
                                 memory_s=None, collective_s=None,
                                 dominant=None, step_time_bound_s=None,
                                 roofline_fraction=None))
        return rec
    rec["memory"].update(output_bytes=t["output"],
                         temp_bytes=t["peak"] - t["held"],
                         traced_argument_bytes=t["held"],
                         peak_bytes=t["peak"])
    rec.update(
        status="ok", flops_per_device=t["flops"],
        hbm_bytes_per_device=t["hbm"],
        collective=dict(wire_bytes_per_device=t["wire"],
                        num_collectives=t["count"], by_op=t["by_op"],
                        seconds=t["seconds"]),
        roofline=rl.roofline_terms(max(t["flops"], exec_per_dev), t["hbm"],
                                   t["wire"], collective_s=t["seconds"]),
        sharded=dict(mode=t["mode"], rule=t["rule"], trace_s=t["trace_s"]),
    )
    return rec


def add_counted(rec: dict, counted: dict | None) -> dict:
    """``rec`` with ``counted_step``'s fields (a cell the reference skips
    takes none)."""
    if "memory" in rec:
        c = counted["counted_flops_global"]
        rec.update(counted, model_to_counted_ratio=(
            rec["model_flops_global"] / c if c else None))
    return rec


def dryrun_cell(arch_id: str, shape_id: str, multi_pod: bool,
                donate: bool = True) -> dict:
    """One cell's record on the production mesh, over the process group
    the caller started."""
    arch = get_arch(arch_id)
    shape = arch.shape(shape_id)
    rec = mesh_record(arch, shape, multi_pod, donate)
    return add_counted(rec, counted_step(arch, shape)
                       if "memory" in rec else None)


def _error(arch_id, shape_id, mp, e) -> dict:
    return dict(arch=arch_id, shape=shape_id, mesh=_mesh_tag(mp),
                status="error", error=repr(e),
                traceback="".join(traceback.format_exception(e)))


def _report(tag: str, rec: dict) -> None:
    extra = ""
    if rec["status"] == "error":
        extra = " " + rec["error"][:120]
    elif rec["status"] == "ok":
        m, t = rec["memory"], rec["roofline"]
        extra = (f" args={m['argument_bytes'] / 1e9:.2f}GB/dev"
                 f" peak={m['peak_bytes'] / 1e9:.2f}GB/dev"
                 f" {t['dominant']}={t['step_time_bound_s']:.4f}s"
                 f" ({rec['sharded']['mode']}, "
                 f"{rec['sharded']['trace_s']}s)")
    elif "memory" in rec:
        extra = " " + rec["skip_reason"][:80]
    print(f"[{rec['status']:7s}] {tag}{extra}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-donate", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch (and optionally --shape) or --all")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s.shape_id) for a in list_archs()
                 for s in get_arch(a).shapes]
    else:
        arch = get_arch(args.arch)
        shapes = ([args.shape] if args.shape
                  else [s.shape_id for s in arch.shapes])
        cells = [(args.arch, s) for s in shapes]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    counted = {}      # a step's counts do not depend on the mesh
    for arch_id, shape_id in cells:
        arch = get_arch(arch_id)
        shape = arch.shape(shape_id)
        if not shape.skip_reason:
            try:
                counted[arch_id, shape_id] = counted_step(arch, shape)
            except Exception as e:  # recorded as the cell's error
                counted[arch_id, shape_id] = e

    failures = 0
    for mp in meshes:
        with fake_process_group(512 if mp else 256):
            for arch_id, shape_id in cells:
                arch = get_arch(arch_id)
                c = counted.get((arch_id, shape_id))
                try:
                    if isinstance(c, Exception):
                        raise c
                    rec = add_counted(mesh_record(
                        arch, arch.shape(shape_id), mp, not args.no_donate),
                        c)
                except Exception as e:  # a failing cell is a bug
                    rec = _error(arch_id, shape_id, mp, e)
                failures += rec["status"] == "error"
                tag = f"{arch_id}__{shape_id}__{_mesh_tag(mp)}"
                (out / f"{tag}.json").write_text(json.dumps(
                    rec, indent=2, default=str))
                _report(tag, rec)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
