"""Serving launcher (port of ``repro/launch/serve.py``): batched scoring for
the recsys arch, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dien \
      [--reduced] [--requests N] [--seed S] [--device cpu]

Without ``--device`` the run goes to the GPU and raises when there is none.
The LM half (batched prefill + decode) raises until ROADMAP A10 (d).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import (Shape, get_arch, list_archs,
                                      make_step, param_builders)
from repro_torch.configs.reduced import reduce_arch
from repro_torch.data.pipeline import recsys_batch
from repro_torch.device import resolve_device


def serve_lm(arch, requests: int, seed: int = 0, device=None):
    raise NotImplementedError(
        f"serving {arch.arch_id} (prefill + decode) is not ported yet "
        f"(ROADMAP A10 (d))")


def serve_recsys(arch, requests: int, seed: int = 0, device=None):
    """Score ``requests`` synthetic users (the step-0 batch of ``seed``)
    with the serve step; returns the CTR probabilities [requests]."""
    dev = resolve_device(device)
    shape = Shape("serve", "serve", dims=dict(batch=requests))
    init_fn, _ = param_builders(arch)
    params = {k: v.to(dev) for k, v in init_fn(
        torch.Generator().manual_seed(seed)).items()}
    batch = recsys_batch(arch, shape, 0, seed, device=dev)
    step = make_step(arch, shape)
    t0 = time.perf_counter()
    probs = step(params, batch)
    mean = float(probs.mean())  # waits for the device
    print(f"scored {requests} requests in {time.perf_counter() - t0:.3f}s; "
          f"mean ctr={mean:.4f}")
    return probs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    arch = reduce_arch(args.arch) if args.reduced else get_arch(args.arch)
    if arch.family == "recsys":
        return serve_recsys(arch, args.requests, args.seed, args.device)
    if arch.family not in ("lm-dense", "lm-moe"):
        raise ValueError(f"{arch.arch_id} is a {arch.family} arch: it has no "
                         f"serving path")
    return serve_lm(arch, args.requests, args.seed, args.device)


if __name__ == "__main__":
    main()
