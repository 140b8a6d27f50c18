"""End-to-end LM training: a small LM for a few hundred steps with
checkpointing and automatic resume (port of ``examples/train_lm.py``).

  python -m repro_torch.examples.train_lm [--steps 200] [--arch ...] \
      [--ckpt-dir D] [--device cpu]

Uses the reduced config of an LM arch (``configs/reduced.py``: 2 layers,
d_model 64, batches of 8 sequences of 64 tokens). Kill it mid-run and
rerun: it resumes from the last valid checkpoint in ``--ckpt-dir``
(default ``repro_lm_ckpt`` under the temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.reduced import reduce_arch
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)

    arch = reduce_arch(args.arch)
    print(f"training {arch.arch_id} "
          f"({arch.model_cfg.param_count():,} params) for {args.steps} steps")
    trainer = Trainer(arch, "train_4k", cfg=TrainerConfig(
        steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir,
        log_every=20), device=args.device)
    log = trainer.run()
    print(f"final loss: {log[-1]['loss']:.4f} "
          f"(started at {log[0]['loss']:.4f})")
    return dict(arch=arch.arch_id, params=arch.model_cfg.param_count(),
                steps=trainer.step, log=log)


if __name__ == "__main__":
    main()
