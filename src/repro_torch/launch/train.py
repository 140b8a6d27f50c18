"""Training launcher, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \
      [--shape ogb_products] [--reduced] [--steps N] [--ckpt-dir D] \
      [--seed S] [--device cpu]

``--arch`` is any registered arch (``configs.base.list_archs()``: the
five LMs phi4-mini-3.8b, qwen1.5-32b, llama3-405b, granite-moe-1b-a400m
and qwen3-moe-30b-a3b; dien, egnn, gcn-cora, gin-tu, mace).
``--reduced`` runs the small config of ``configs/reduced.py`` (for an LM:
2 layers, d_model 64, sequences of 64 tokens); the default shape is the
arch's first train shape (``train_4k`` for the LMs, ``full_graph_sm`` for
the GNNs, ``train_batch`` for dien). An LM at full width and ``train_4k``
(256 sequences of 4,096 tokens) does not fit one card.
Without ``--device`` the run goes to the GPU and raises when there is none.
Model parallelism is not ported (ROADMAP A9): ``--model-parallel`` above 1
raises.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.configs.reduced import reduce_arch
from repro_torch.train.trainer import Trainer, TrainerConfig


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
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 is not ported yet (ROADMAP A9)")

    arch = reduce_arch(args.arch) if args.reduced else get_arch(args.arch)
    shape_id = args.shape or next(s.shape_id for s in arch.shapes
                                  if s.kind == "train")
    trainer = Trainer(arch, shape_id, cfg=TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, seed=args.seed), device=args.device)
    return trainer.run()


if __name__ == "__main__":
    main()
