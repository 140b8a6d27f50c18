#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

  python3 chip_smoke.py [--scale 20] [--roots 64] [--reps 20]

Run from the repository root. The graph is Graph500 R-MAT at edgefactor 16
from seed 0; --scale, --roots and --reps cut a quick check short. Each phase
prints one JSON line:
  device   the card, as torch and nvidia-smi name it, with its power limit;
  build    the CUDA kernels compiled from src/repro_torch/csrc/*.cu (sm_90a);
  graph    the Graph500 R-MAT graph built on the card;
  kernel   each kernel against its plain PyTorch version on the card, on a
           seeded random visited/frontier split and on every layer state of
           one hybrid BFS: outputs must be bit-equal; times from CUDA events;
  layers   where one hybrid BFS spends its time, layer by layer;
  main     the serial Graph500 harness (hybrid, all roots) through
           run_graph500, with the launch counts of that run alone, then the
           validator, the numpy oracle and the cross-mode checks;
  kernels  one entry per ported kernel (counts, errors, times, bounds).
The last line is {"ok": true, "device": {...}}. Any failure raises and
exits nonzero; so does a machine without a GPU or a directory without the
repository's src/.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import bitmap  # noqa: E402
from repro_torch.core.bottomup import _fallback_scan, bottomup_simd_step  # noqa: E402
from repro_torch.core.csr import to_numpy_adj  # noqa: E402
from repro_torch.core.hybrid import MAX_TRACE, bfs  # noqa: E402
from repro_torch.core.ref import bfs_reference  # noqa: E402
from repro_torch.core.topdown import topdown_step  # noqa: E402
from repro_torch.graph.generator import rmat_graph, sample_roots  # noqa: E402
from repro_torch.graph.graph500 import run_graph500  # noqa: E402
from repro_torch.graph.validate import validate_bfs_tree  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.bottom_up_probe.kernel import (  # noqa: E402
    bottom_up_probe_cuda)
from repro_torch.kernels.bottom_up_probe.ref import (  # noqa: E402
    bottom_up_probe_ref, probe_rounds)
from repro_torch.kernels.topdown_scan.kernel import topdown_scan_cuda  # noqa: E402
from repro_torch.kernels.topdown_scan.ref import topdown_best_ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): HBM3 bytes/s, and
# the 32-bit rate outside the tensor cores, used for the integer operations
# of these kernels (the card's int32 rate is not higher, so the bound holds).
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
MAX_POS = 8
EDGEFACTOR = 16
SEED = 0

KERNELS = {
    "bottom_up_probe": dict(
        route="cuda", source="src/repro_torch/csrc/bottom_up_probe.cu",
        replaces="src/repro/kernels/bottom_up_probe/kernel.py:56"),
    "topdown_scan": dict(
        route="cuda", source="src/repro_torch/csrc/topdown_scan.cu",
        replaces="src/repro/kernels/topdown_scan/kernel.py:39"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after a warm-up.
    ``flush`` (larger than L2) is overwritten before each run, so the run
    starts with a cold L2 and the device is busy while the host launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` followed by a device sync, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_cost(n, n_unvisited, probes, nw):
    # reads: unvisited + parent for all, starts + deg for unvisited, one
    # neighbour id per probe, the frontier words; writes: found + parent
    nbytes = 8 * n + 8 * n_unvisited + 4 * probes + 4 * nw + 8 * n
    ops = 4 * n + 8 * probes
    return bound_ms(nbytes, ops)


def scan_cost(n, m, active_edges, nw):
    # reads: src_idx for every slot, col_idx for slots whose source is in
    # the frontier, both bitmaps; writes: best
    nbytes = 4 * m + 4 * active_edges + 8 * nw + 4 * n
    ops = 4 * m + 6 * active_edges
    return bound_ms(nbytes, ops)


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def layer_states(g, out):
    """(frontier, visited, parent) at the start of every layer of ``out``."""
    depth, parent = out.depth, out.parent
    for layer in range(int(out.num_layers)):
        visited = (depth >= 0) & (depth <= layer)
        yield (layer, depth == layer, visited,
               torch.where(visited, parent, -1))


def compare_kernels(g, out, dev, reps, flush):
    """Each kernel against its plain version: a seeded random split, then
    every layer state of ``out``. Returns the per-kernel record."""
    n, m = g.n, g.m
    starts, deg = g.row_ptr[:-1], g.deg
    rng = np.random.default_rng(SEED)
    vis = torch.from_numpy(rng.random(n) < 0.4).to(dev)
    fro = torch.from_numpy(rng.random(n) < 0.25).to(dev) & ~vis
    par0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cases = [("random", fro, vis, par0)] + [
        (f"layer{layer}", f, v, p) for layer, f, v, p in layer_states(g, out)]
    rec = {name: dict(cases=0, max_abs_err=0) for name in KERNELS}
    for label, f, v, p in cases:
        fw, vw = bitmap.pack(f), bitmap.pack(v)
        unv = (~v).to(torch.int32)
        probe_args = (starts, deg, unv, p, g.col_idx, fw, MAX_POS)
        scan_args = (g.src_idx, g.col_idx, fw, vw, n)
        k_probe = bottom_up_probe_cuda(*probe_args)
        r_probe = bottom_up_probe_ref(*probe_args)
        k_scan = topdown_scan_cuda(*scan_args)
        r_scan = topdown_best_ref(*scan_args)
        torch.cuda.synchronize()
        for name, k, r in (("bottom_up_probe", k_probe, r_probe),
                           ("topdown_scan", (k_scan,), (r_scan,))):
            err = max_abs_err(zip(k, r))
            check(err == 0 and all(torch.equal(a, b) for a, b in zip(k, r)),
                  f"{name} differs from its plain version on {label}")
            rec[name]["cases"] += 1
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        if label.startswith("layer"):
            nxt = (out.depth == int(label[5:]) + 1)
            check(torch.equal((k_scan < n) & ~v, nxt),
                  f"topdown_scan on {label} does not give the next layer")
        if label != "random":
            continue
        nw = fw.numel()
        # neighbour gathers: every live round up to and including the hit
        probes = sum(int(live.sum()) for live, _, _ in probe_rounds(
            starts, deg, unv, g.col_idx, fw, MAX_POS))
        active = int(torch.where(f, deg, 0).sum())
        for name, args, fn, plain, cost in (
                ("bottom_up_probe", probe_args, bottom_up_probe_cuda,
                 bottom_up_probe_ref,
                 probe_cost(n, int(unv.sum()), probes, nw)),
                ("topdown_scan", scan_args, topdown_scan_cuda,
                 topdown_best_ref, scan_cost(n, m, active, nw))):
            rec[name].update(
                ms=time_ms(lambda: fn(*args), reps, flush),
                plain_ms=time_ms(lambda: plain(*args), reps, flush),
                bound_ms=cost[0], bound_by=cost[1])
        rec["bottom_up_probe"]["timed_input"] = dict(
            case="random", unvisited=int(unv.sum()), probes=probes)
        rec["topdown_scan"]["timed_input"] = dict(
            case="random", active_edges=active)
    for name, r in rec.items():
        emit("kernel", name=name, bit_equal=True, **r)
    return rec


def layer_breakdown(g, root, out, reps, flush):
    """Time one hybrid BFS layer by layer: the counters' host sync, the
    step the controller chose, and inside it the kernel and the fallback."""
    n, deg = g.n, g.deg
    dirs = out.trace_dir.tolist()
    rows = []
    for layer, f, v, p in layer_states(g, out):
        td = dirs[layer] == 0

        def counters():
            torch.stack([f.sum(), torch.where(f, deg, 0).sum(),
                         torch.where(v, 0, deg).sum()]).tolist()

        fw = bitmap.pack(f)
        row = dict(layer=layer, dir="TD" if td else "BU",
                   v_f=int(out.trace_vf[layer]),
                   counters_ms=wall_ms(counters, reps))
        if td:
            vw = bitmap.pack(v)
            row["step_ms"] = wall_ms(lambda: topdown_step(g, f, v, p), reps)
            row["kernel_ms"] = time_ms(
                lambda: topdown_scan_cuda(g.src_idx, g.col_idx, fw, vw, n),
                reps, flush)
        else:
            unv = (~v).to(torch.int32)
            row["step_ms"] = wall_ms(
                lambda: bottomup_simd_step(g, f, v, p, MAX_POS), reps)
            row["kernel_ms"] = time_ms(
                lambda: bottom_up_probe_cuda(g.row_ptr[:-1], deg, unv, p,
                                             g.col_idx, fw, MAX_POS),
                reps, flush)
            found, _ = bottom_up_probe_ref(g.row_ptr[:-1], deg, unv, p,
                                           g.col_idx, fw, MAX_POS)
            rem = ~v & (found == 0) & (deg > MAX_POS)
            row["residue"] = int(rem.sum())
            # the step skips the fallback when no vertex is left for it
            row["fallback_ms"] = wall_ms(
                lambda: _fallback_scan(g, fw, rem, p, MAX_POS),
                reps) if row["residue"] else 0.0
        rows.append(row)
    emit("layers", root=root, rows=rows,
         step_ms_total=sum(r["step_ms"] + r["counters_ms"] for r in rows))


def run_main_path(g, args):
    """The serial Graph500 harness through the port's entry point, then
    its checks. Returns (result, launches of the harness run)."""
    common.reset_launches()
    t0 = time.perf_counter()
    res = run_graph500(args.scale, EDGEFACTOR, mode="hybrid",
                       num_roots=args.roots, seed=SEED, graph=g)
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    rp, ci = to_numpy_adj(g)
    roots = res.roots
    validated = []
    for r in roots[:8]:
        out = bfs(g, r, "hybrid")
        validate_bfs_tree(rp, ci, out.parent.cpu().numpy(), r)
        validated.append(r)
    r0 = roots[0]
    out0 = bfs(g, r0, "hybrid")
    pref, dref = bfs_reference(rp, ci, r0)
    check(np.array_equal(out0.parent.cpu().numpy(), pref),
          "hybrid parent differs from bfs_reference")
    check(np.array_equal(out0.depth.cpu().numpy(), dref),
          "hybrid depth differs from bfs_reference")
    for r in roots[:2]:
        ph = bfs(g, r, "hybrid").parent
        for mode in ("topdown", "bottomup_simd"):
            check(torch.equal(bfs(g, r, mode).parent, ph),
                  f"{mode} parent differs from hybrid for root {r}")
    n_layers = int(out0.num_layers)
    times_ms = np.asarray(res.times) * 1e3
    emit("main", entry="repro_torch.graph.graph500.run_graph500",
         seconds=seconds, launches=launches,
         validated_roots=validated, oracle_root=r0, cross_mode_roots=roots[:2],
         layers=n_layers, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         trace_dir=out0.trace_dir[:n_layers].tolist(),
         time_ms_median=float(np.median(times_ms)),
         time_ms_p84=float(np.percentile(times_ms, 84)), **res.summary())
    check(all(t > 0 for t in res.teps), "a root traversed no edges")
    check(n_layers < MAX_TRACE, "BFS did not finish within the trace buffer")
    return res, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--roots", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    common.load_library()
    emit("build", load_seconds=time.perf_counter() - t0,
         nvcc_flags=list(common.NVCC_FLAGS), **common.build_info)

    t0 = time.perf_counter()
    g = rmat_graph(args.scale, EDGEFACTOR, seed=SEED)
    torch.cuda.synchronize()
    csr_bytes = sum(t.numel() * t.element_size() for t in g)
    emit("graph", scale=args.scale, edgefactor=EDGEFACTOR, n=g.n, m=g.m,
         device=str(g.device), csr_bytes=csr_bytes,
         seconds=time.perf_counter() - t0)
    check(g.device.type == "cuda", "graph is not on the GPU")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    probe_root = int(sample_roots(g, 1, seed=SEED + 1)[0])
    states = bfs(g, probe_root, "hybrid")
    rec = compare_kernels(g, states, dev, args.reps, flush)
    layer_breakdown(g, probe_root, states, max(args.reps // 4, 3), flush)
    del flush
    torch.cuda.reset_peak_memory_stats()

    res, launches = run_main_path(g, args)

    kernels = [dict(name=name, **KERNELS[name], launches=launches[name],
                    launches_per_bfs=launches[name] / (len(res.roots) + 1),
                    max_abs_err=rec[name]["max_abs_err"], ms=rec[name]["ms"],
                    plain_ms=rec[name]["plain_ms"],
                    bound_ms=rec[name]["bound_ms"],
                    bound_by=rec[name]["bound_by"], library_ms=None)
               for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
