"""Trainer: step execution, checkpoint/restart and elastic re-mesh (port
of ``repro/train/trainer.py``).

Fault-tolerance model, as the reference's:
  * checkpoint every ``ckpt_every`` steps through the atomic manager;
  * on (re)start, ``run`` restores the newest valid checkpoint and replays
    the data stream from that step (pipelines are step-keyed, so the
    stream position is implied by the step counter);
  * ``remesh(new_mesh)`` gathers the whole state to the host and puts it
    back on another mesh (elastic scale-up or -down after a node loss);
    checkpoints hold whole tensors, so they do not depend on the mesh.
The kernels are deterministic (no float atomics), so a resumed run repeats
an unbroken one bit for bit on the same device and mesh.

On a mesh of more than one device the step is ``train/sharded.py``'s: each
rank holds its shards of the parameters and the optimizer state, draws the
whole batch (step-keyed, the same on every rank) and takes its block of
it. A process group has a fixed size, so a smaller mesh is a
``DeviceMesh`` over some of its ranks; a rank off the mesh holds nothing
and skips the steps (``on_mesh``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import Arch, make_step, param_builders
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import mesh_size
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.sharded import make_sharded_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str | None = None
    seed: int = 0
    log_every: int = 10


class Trainer:
    """Trains ``arch`` at ``shape_id`` on ``device`` (default: the GPU;
    raises without one), on ``mesh`` when it has more than one device."""

    def __init__(self, arch: Arch, shape_id: str, mesh=None,
                 cfg: TrainerConfig = TrainerConfig(), device=None):
        self.arch = arch
        self.shape = arch.shape(shape_id)
        if self.shape.kind != "train":
            raise ValueError(f"Trainer drives train shapes, not "
                             f"{self.shape.kind}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir)
                     if cfg.ckpt_dir else None)
        self.metrics_log: list[dict] = []
        self._build()

    # ------------------------------------------------------------------ build
    @property
    def sharded(self) -> bool:
        return mesh_size(self.mesh) > 1

    @property
    def on_mesh(self) -> bool:
        """Whether this rank is on the mesh (always without one)."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

    def _build(self, state=None):
        """The step for the current mesh, and the state on it: ``state``
        (whole tensors) or, by default, a fresh one from the seed."""
        if state is None and not self.on_mesh:
            state = ({}, {})
        elif state is None:
            init_fn, _ = param_builders(self.arch, self.shape)
            # a CPU generator: the same initial parameters on every device
            # and every rank
            params = init_fn(torch.Generator().manual_seed(self.cfg.seed))
            state = params, init_opt_state(params, self.arch.opt)
        params, opt = _to(state, self.device)
        self._sharded = None
        if not self.on_mesh:
            self.params = self.opt_state = None
            self._step_fn = None
        elif self.sharded:
            self._sharded = make_sharded_step(self.arch, self.shape,
                                              self.mesh)
            self.params, self.opt_state = self._sharded.place(params, opt)
            self._step_fn = self._sharded
        else:
            self.params, self.opt_state = params, opt
            self._step_fn = make_step(self.arch, self.shape)
        self.step = 0

    def full_state(self):
        """(params, optimizer state) as whole tensors on this rank (every
        rank of a mesh calls it; None off the mesh)."""
        if self._sharded is not None:
            return self._sharded.gather(self.params, self.opt_state)
        if not self.on_mesh:
            return None
        return self.params, self.opt_state

    # ------------------------------------------------------------- lifecycle
    def maybe_restore(self) -> int:
        if self.ckpt is None or not self.on_mesh:
            return self.step
        like = (self._sharded.whole_like(self.params, self.opt_state)
                if self._sharded is not None
                else (self.params, self.opt_state))
        state, step = self.ckpt.restore({"params": like[0], "opt": like[1]})
        if state is not None:
            if self._sharded is not None:
                self.params, self.opt_state = self._sharded.place(
                    state["params"], state["opt"])
            else:
                self.params, self.opt_state = state["params"], state["opt"]
            self.step = step
        return self.step

    def save(self):
        """Write the whole state: gathered from the shards on a mesh (every
        rank of it calls this) and written by its first rank."""
        if self.ckpt is None or not self.on_mesh:
            return
        params, opt = self.full_state()
        if self._sharded is None or self._sharded.sp.rank == 0:
            self.ckpt.save(self.step, {"params": params, "opt": opt})

    def remesh(self, new_mesh):
        """Elastic restart on another mesh (None: one device): gather the
        state whole, re-resolve the shardings and put it back. The values
        are carried over exactly. Every rank of the old and the new mesh
        calls it."""
        state = self.full_state()
        step = self.step
        self.mesh = new_mesh
        if state is None and self.on_mesh:
            raise NotImplementedError(
                "a rank joins the mesh holding no state: restore it from "
                "a checkpoint")
        self._build(None if state is None else _cpu(state))
        self.step = step

    # ------------------------------------------------------------------- run
    def run_step(self) -> dict | None:
        """One step (None on a rank off the mesh, which skips it)."""
        if not self.on_mesh:
            self.step += 1
            return None
        batch = make_batch(self.arch, self.shape, self.step,
                           seed=self.cfg.seed, device=self.device)
        if self._sharded is not None:
            batch = self._sharded.shard_batch(batch)
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
            if metrics is not None and (self.step % self.cfg.log_every == 0
                                        or self.step == steps):
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=self.step, wall=time.perf_counter() - t0)
                self.metrics_log.append(m)
                if self._sharded is None or self._sharded.sp.rank == 0:
                    print(f"step {self.step:5d} " + " ".join(
                        f"{k}={v:.5g}" for k, v in m.items()
                        if k != "step"), flush=True)
            if self.ckpt is not None and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self.ckpt is not None:
            self.save()
        return self.metrics_log


def _cpu(tree):
    if isinstance(tree, (tuple, dict)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: _cpu(v) for k, v in items}
        return out if isinstance(tree, dict) else tuple(out.values())
    return tree.detach().cpu()


def _to(state, device):
    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return tree.to(device)
    return tuple(move(t) for t in state)
