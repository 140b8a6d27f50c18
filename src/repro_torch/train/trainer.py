"""Trainer: step execution + checkpoint/restart (port of
``repro/train/trainer.py``).

Fault-tolerance model, as the reference's:
  * checkpoint every ``ckpt_every`` steps through the atomic manager;
  * on (re)start, ``run`` restores the newest valid checkpoint and replays
    the data stream from that step (pipelines are step-keyed, so the
    stream position is implied by the step counter).
The kernels are deterministic (no float atomics), so a resumed run repeats
an unbroken one bit for bit on the same device. Elastic re-meshing and
meshes of more than one device raise until the distributed slice (ROADMAP
A9).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import Arch, make_step, param_builders
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.checkpoint import CheckpointManager

_NO_MESH = "multi-device training is not ported yet (ROADMAP A9)"


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str | None = None
    seed: int = 0
    log_every: int = 10


class Trainer:
    """Trains ``arch`` at ``shape_id`` on ``device`` (default: the GPU;
    raises without one)."""

    def __init__(self, arch: Arch, shape_id: str, mesh=None,
                 cfg: TrainerConfig = TrainerConfig(), device=None):
        if mesh is not None and getattr(mesh, "size", 1) > 1:
            raise NotImplementedError(_NO_MESH)
        self.arch = arch
        self.shape = arch.shape(shape_id)
        if self.shape.kind != "train":
            raise ValueError(f"Trainer drives train shapes, not "
                             f"{self.shape.kind}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir)
                     if cfg.ckpt_dir else None)
        self.metrics_log: list[dict] = []
        self._build()

    def _build(self):
        init_fn, _ = param_builders(self.arch, self.shape)
        # a CPU generator: the same initial parameters on every device
        gen = torch.Generator().manual_seed(self.cfg.seed)
        self.params = {k: v.to(self.device) for k, v in init_fn(gen).items()}
        self.opt_state = init_opt_state(self.params, self.arch.opt)
        self._step_fn = make_step(self.arch, self.shape)
        self.step = 0

    def maybe_restore(self) -> int:
        if self.ckpt is None:
            return 0
        state, step = self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state})
        if state is not None:
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = step
        return self.step

    def save(self):
        if self.ckpt is not None:
            self.ckpt.save(self.step,
                           {"params": self.params, "opt": self.opt_state})

    def remesh(self, new_mesh):
        raise NotImplementedError(_NO_MESH)

    def run_step(self) -> dict:
        batch = make_batch(self.arch, self.shape, self.step,
                           seed=self.cfg.seed, device=self.device)
        self.params, self.opt_state, metrics = self._step_fn(
            self.params, self.opt_state, batch)
        self.step += 1
        return metrics

    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps or self.cfg.steps
        self.maybe_restore()
        t0 = time.perf_counter()
        while self.step < steps:
            metrics = self.run_step()
            if self.step % self.cfg.log_every == 0 or self.step == steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=self.step, wall=time.perf_counter() - t0)
                self.metrics_log.append(m)
                print(f"step {self.step:5d} " + " ".join(
                    f"{k}={v:.5g}" for k, v in m.items() if k != "step"),
                    flush=True)
            if self.ckpt is not None and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self.ckpt is not None:
            self.save()
        return self.metrics_log
