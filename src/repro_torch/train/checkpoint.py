"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``).

Atomic protocol, as the reference's: write ``step_N.npz.tmp``, fsync, hash
it (sha256), rename it into place, then publish a manifest holding the hash
the same way. ``restore`` takes the newest checkpoint whose manifest hash
verifies, so a preemption mid-write (a torn ``.tmp``) or a corrupted file
falls back to the previous valid step. A checkpoint stores host copies of
the tensors under flat ``/``-joined key paths of the state's nested dicts;
a dtype numpy lacks (bfloat16, float8) is stored as its bits in an
unsigned integer of the same width.

Checkpoints hold whole tensors and do not depend on the mesh: the
sharded trainer gathers its shards before it saves and puts the restored
tensors back on its own placements (``train/trainer.py``). A meta tensor
in the restore template stands for a host tensor of its shape and dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
from pathlib import Path

import numpy as np
import torch


def _flatten_with_paths(state, prefix: str = ""):
    """(path, tensor) pairs of nested dicts of tensors, in insertion order."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                           else str(k))
    else:
        yield prefix, state


def _unflatten_like(state_like, leaves):
    if isinstance(state_like, dict):
        return {k: _unflatten_like(v, leaves) for k, v in state_like.items()}
    return next(leaves)


_BITS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8}


def _host_array(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype in _BITS:
        x = x.view(_BITS[x.dtype])
    return x.numpy()


def _from_host(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if ref.dtype in _BITS and t.dtype == _BITS[ref.dtype]:
        t = t.view(ref.dtype)
    return t.to(ref.dtype) if ref.is_meta else t.to(ref.device, ref.dtype)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, state) -> Path:
        """state: nested dicts of tensors. Returns the checkpoint's path."""
        named = list(_flatten_with_paths(state))
        arrays = {f"a{i}": _host_array(x) for i, (_, x) in enumerate(named)}
        paths = [p for p, _ in named]
        final = self.dir / f"step_{step:010d}.npz"
        tmp = final.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, __paths__=np.asarray(json.dumps(paths)), **arrays)
            f.flush()
            os.fsync(f.fileno())
        digest = _sha256(tmp)
        os.replace(tmp, final)                      # atomic publish
        manifest = final.with_suffix(".json")
        manifest_tmp = manifest.with_suffix(".json.tmp")
        manifest_tmp.write_text(json.dumps(
            dict(step=step, file=final.name, sha256=digest,
                 time=time.time())))
        os.replace(manifest_tmp, manifest)
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*.npz"))
        for old in ckpts[:-self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)

    def _candidates(self):
        steps = []
        for mf in self.dir.glob("step_*.json"):
            m = re.match(r"step_(\d+)\.json", mf.name)
            if m:
                steps.append((int(m.group(1)), mf))
        return sorted(steps, reverse=True)

    def latest_step(self) -> int | None:
        for step, mf in self._candidates():
            if self._verify(mf):
                return step
        return None

    def _verify(self, manifest: Path) -> bool:
        try:
            meta = json.loads(manifest.read_text())
            ckpt = self.dir / meta["file"]
            return ckpt.exists() and _sha256(ckpt) == meta["sha256"]
        except (OSError, ValueError, KeyError):
            return False

    def restore(self, state_like, step: int | None = None):
        """Restore into the structure of ``state_like``: the same key paths
        and shapes; each tensor takes its ``state_like`` counterpart's dtype
        and device (the host for a meta tensor). Returns (state, step), or (None, None) when no valid
        checkpoint exists."""
        cands = self._candidates()
        if step is not None:
            cands = [(s, m) for s, m in cands if s == step]
        for s, mf in cands:
            if not self._verify(mf):
                continue  # torn/corrupt -> fall back to older
            meta = json.loads(mf.read_text())
            with np.load(self.dir / meta["file"], allow_pickle=False) as z:
                paths = json.loads(str(z["__paths__"]))
                arrays = [z[f"a{i}"] for i in range(len(paths))]
            refs = list(_flatten_with_paths(state_like))
            if [p for p, _ in refs] != paths:
                raise ValueError(f"checkpoint {meta['file']} holds "
                                 f"{paths}, the state {[p for p, _ in refs]}")
            out = []
            for (path, ref), arr in zip(refs, arrays):
                if tuple(ref.shape) != arr.shape:
                    raise ValueError(f"{path}: checkpoint shape {arr.shape}"
                                     f", state shape {tuple(ref.shape)}")
                out.append(_from_host(arr, ref))
            return _unflatten_like(state_like, iter(out)), s
        return None, None
