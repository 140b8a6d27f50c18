"""Launch an SPMD function on ``ndev`` ranks, one process each.

The reference runs its distributed engines under ``shard_map`` in one
process and forces host devices with ``XLA_FLAGS`` to test them on a CPU.
PyTorch runs one process per rank, so ``run_ranks`` starts ``ndev`` spawned
processes, initialises a process group in each (a ``FileStore`` in a
temporary directory; gloo on the CPU, NCCL on the GPU, rank ``r`` on
``cuda:r``), calls ``fn(*args)`` in every rank, and returns rank 0's return
value. Every rank runs the same code on the same arguments, as an engine's
SPMD program expects; the engines build their mesh with
``core.dist_msbfs.host_mesh(ndev, device)``.

``fn`` must be importable by name from a fresh process (a module-level
function of an importable module, or of the ``__main__`` script), and its
arguments and return value picklable. A rank that raises stops the launch:
the other ranks are terminated and ``run_ranks`` raises with the failing
rank's traceback.

  from repro_torch.distributed.ranks import run_ranks
  out = run_ranks(fn, 4, graph_path, device="cpu")

A graph goes to the ranks by file (``save_graph`` in the parent,
``load_graph`` in each rank): building a large R-MAT graph once on the host
is far cheaper than once per rank, and pickling it through the spawn would
copy it through a pipe.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

__all__ = ["load_graph", "rank_device", "run_ranks", "save_graph"]

_POLL_S = 0.05
# the ranks are killed, and run_ranks raises, when they outlive this
_TIMEOUT_S = 600.0


def rank_device(device=None) -> torch.device:
    """This rank's device: the current CUDA device (``run_ranks`` sets
    ``cuda:<rank>``) for ``device=None`` or "cuda", else ``device``."""
    if device is None or torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def save_graph(g, path) -> None:
    """Write a ``CSRGraph``'s or a ``WeightedCSRGraph``'s arrays to
    ``path`` (an uncompressed npz)."""
    np.savez(path, **{name: a.cpu().numpy()
                      for name, a in zip(g._fields, g)})


def load_graph(path, device):
    """The graph that ``save_graph`` wrote (weighted if it was), on
    ``device``."""
    from repro_torch.core.csr import (from_numpy_graph,
                                      from_numpy_weighted_graph)
    with np.load(path) as f:
        if "weights" in f:
            return from_numpy_weighted_graph(f["row_ptr"], f["col_idx"],
                                             f["src_idx"], f["weights"],
                                             device)
        return from_numpy_graph(f["row_ptr"], f["col_idx"], f["src_idx"],
                                device)


def _backend(device) -> str:
    if device is None or torch.device(device).type == "cuda":
        return "nccl"
    if torch.device(device).type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def _rank_main(rank, ndev, backend, store_path, result_path, fn, args):
    import torch.distributed as dist
    status = 1
    try:
        kwargs = {}
        if backend == "nccl":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            kwargs["device_id"] = dev
        else:
            # the CPU ranks share the host's cores: one thread each, as
            # torchrun sets OMP_NUM_THREADS=1 for more than one process
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, ndev)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=ndev, **kwargs)
        out = fn(*args)
        with open(f"{result_path}.{rank}", "wb") as f:
            pickle.dump(("ok", out if rank == 0 else None), f)
        status = 0
    except BaseException:
        with open(f"{result_path}.{rank}", "wb") as f:
            pickle.dump(("error", traceback.format_exc(), time.time()), f)
    # a failed rank exits at once: other ranks may be waiting in a
    # collective with it, and tearing the group down could wait on them
    if status == 0 and dist.is_initialized():
        dist.destroy_process_group()
    os._exit(status)


def run_ranks(fn, ndev: int, *args, device=None):
    """Run ``fn(*args)`` on ``ndev`` ranks and return rank 0's result.

    ``device=None`` (or "cuda") puts rank ``r`` on ``cuda:r`` with NCCL and
    needs ``ndev <= torch.cuda.device_count()``; ``device="cpu"`` runs gloo
    ranks on the CPU. Raises with the traceback of the rank that raised
    first, or when the ranks outlive ``_TIMEOUT_S`` seconds (they are
    killed then)."""
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    backend = _backend(device)
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if ndev > have:
            raise RuntimeError(
                f"run_ranks(ndev={ndev}) on the GPU needs {ndev} CUDA "
                f"devices, and {have} are available (NCCL takes one device "
                f"per rank); pass device='cpu' for gloo ranks on the CPU")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store_path = os.path.join(tmp, "store")
        result_path = os.path.join(tmp, "result")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, ndev, backend, store_path, result_path,
                                   fn, args), daemon=True)
                 for r in range(ndev)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + _TIMEOUT_S
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(_POLL_S)
            else:
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed is None and any(p.exitcode != 0 for p in procs):
            raise TimeoutError(
                f"run_ranks: {ndev} ranks of {getattr(fn, '__name__', fn)} "
                f"did not finish within {_TIMEOUT_S} s")
        if failed is not None:
            # the rank that raised first: a rank whose peer died may raise
            # in its collective a moment later, and report that instead
            errors = sorted((t, r, text) for r in range(ndev)
                            for t, text in [_error(result_path, r)]
                            if text is not None)
            if errors:
                _, failed, text = errors[0]
            else:
                text = "(the rank left no traceback)"
            raise RuntimeError(
                f"run_ranks: rank {failed} of {ndev} failed (exit code "
                f"{procs[failed].exitcode}):\n{text}")
        return _load(result_path, 0)[1]


def _load(result_path: str, rank: int):
    with open(f"{result_path}.{rank}", "rb") as f:
        return pickle.load(f)


def _error(result_path: str, rank: int) -> tuple:
    """(time, traceback) of a rank that raised, else (inf, None)."""
    try:
        report = _load(result_path, rank)
    except (OSError, EOFError, pickle.UnpicklingError):
        return float("inf"), None
    if report[0] != "error":
        return float("inf"), None
    return report[2], report[1]
