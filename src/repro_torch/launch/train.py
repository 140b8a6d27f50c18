"""Training launcher, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \
      [--shape ogb_products] [--reduced] [--steps N] [--ckpt-dir D] \
      [--seed S] [--device cpu] [--model-parallel K]

``--arch`` is any registered arch (``configs.base.list_archs()``: the
five LMs phi4-mini-3.8b, qwen1.5-32b, llama3-405b, granite-moe-1b-a400m
and qwen3-moe-30b-a3b; dien, egnn, gcn-cora, gin-tu, mace).
``--reduced`` runs the small config of ``configs/reduced.py`` (for an LM:
2 layers, d_model 64, sequences of 64 tokens); the default shape is the
arch's first train shape (``train_4k`` for the LMs, ``full_graph_sm`` for
the GNNs, ``train_batch`` for dien). An LM at full width and ``train_4k``
(256 sequences of 4,096 tokens) does not fit one card.
Without ``--device`` the run goes to the GPU and raises when there is none.

On several ranks (``torchrun --nproc-per-node N -m repro_torch.launch.train
... --model-parallel k``: NCCL on the GPUs, one a rank, or gloo with
``--device cpu``; or a process group the caller started) the run trains on
``launch/mesh.py::host_device_mesh(k)``, a ("data", "model") mesh of N / k
by k over the group's ranks, through the sharded step
(``train/sharded.py``). Without a group the run is one rank, where
``--model-parallel`` above 1 cannot split.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.configs.reduced import reduce_arch
from repro_torch.launch.mesh import host_device_mesh
from repro_torch.train.trainer import Trainer, TrainerConfig


def _start_group(device) -> bool:
    """Start the process group from ``torchrun``'s environment (NCCL on
    the GPU, each rank on GPU ``LOCAL_RANK``; gloo on the CPU) when it is
    set and no group is. Whether it started one."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    return True


def _mesh(model_parallel: int):
    """``host_device_mesh(model_parallel)`` over the process group, or
    None without one (one rank)."""
    if not dist.is_initialized():
        if model_parallel > 1:
            raise ValueError(f"--model-parallel {model_parallel} on one "
                             f"rank: start the ranks with torchrun")
        return None
    return host_device_mesh(model_parallel)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default=None,
                    help="train shape id (default: first train shape)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)

    arch = reduce_arch(args.arch) if args.reduced else get_arch(args.arch)
    shape_id = args.shape or next(s.shape_id for s in arch.shapes
                                  if s.kind == "train")
    started = _start_group(args.device)
    try:
        trainer = Trainer(arch, shape_id, mesh=_mesh(args.model_parallel),
                          cfg=TrainerConfig(steps=args.steps,
                                            ckpt_every=args.ckpt_every,
                                            ckpt_dir=args.ckpt_dir,
                                            seed=args.seed),
                          device=args.device)
        return trainer.run()
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
