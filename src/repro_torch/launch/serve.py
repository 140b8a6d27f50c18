"""Serving launcher (port of ``repro/launch/serve.py``): batched prefill
and greedy decode for the LM archs, batched scoring for the recsys arch,
on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      [--reduced] [--requests N] [--prompt-len P] [--new-tokens T] \
      [--seed S] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dien \
      [--reduced] [--requests N] [--seed S] [--device cpu]

Without ``--device`` the run goes to the GPU and raises when there is none.
An LM's parameters and prompts are drawn from generators on the device
(seeded ``seed`` and ``seed + 1``): the reference's distributions, not its
values.
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
from repro_torch.models.transformer import lm_decode_step, lm_prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_serve_inputs(arch, requests: int, prompt_len: int, seed: int = 0,
                    device=None):
    """(parameters, prompts int32[requests, prompt_len]) that ``serve_lm``
    serves, drawn on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    init_fn, _ = param_builders(arch)
    params = init_fn(torch.Generator(device=dev).manual_seed(seed))
    toks = torch.randint(0, arch.model_cfg.vocab, (requests, prompt_len),
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 1), dtype=torch.int32, device=dev)
    return params, toks


@torch.inference_mode()
def generate(params: dict, toks: torch.Tensor, cfg, new_tokens: int,
             stats: dict | None = None) -> torch.Tensor:
    """Greedy decode of ``new_tokens`` tokens after the prompts ``toks``:
    one prefill into a cache with room for them, then ``new_tokens - 1``
    decode steps, each writing into that cache in place. Returns the tokens
    int32[B, new_tokens]. ``stats``, when given, gets ``prefill_s`` and
    ``decode_s`` (each ending in a device sync) and ``logits_finite``
    (every step's logits finite)."""
    dev = toks.device
    prompt_len = toks.shape[1]
    t0 = time.perf_counter()
    logits, cache = lm_prefill(params, toks, cfg,
                               max_len=prompt_len + new_tokens)
    finite = torch.isfinite(logits).all()
    out = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    for i in range(new_tokens - 1):
        logits, cache = lm_decode_step(params, out[-1], cache,
                                       prompt_len + i, cfg)
        finite = finite & torch.isfinite(logits).all()
        out.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    tokens = torch.cat(out, 1)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t1
        stats["logits_finite"] = bool(finite)
    return tokens


def serve_lm(arch, requests: int, prompt_len: int, new_tokens: int,
             seed: int = 0, device=None, stats: dict | None = None):
    """Serve ``requests`` random prompts of ``prompt_len`` tokens, greedy
    ``new_tokens`` tokens each; prints the reference's throughput line and
    returns the tokens int32[requests, new_tokens]. ``stats``: as
    ``generate``'s, plus ``seconds`` (prefill and decode, as printed)."""
    dev = resolve_device(device)
    params, toks = lm_serve_inputs(arch, requests, prompt_len, seed, dev)
    _sync(dev)
    t0 = time.perf_counter()
    tokens = generate(params, toks, arch.model_cfg, new_tokens, stats)
    _sync(dev)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats["seconds"] = dt
    print(f"served {requests} requests x {new_tokens} tokens "
          f"in {dt:.2f}s ({requests * new_tokens / dt:.1f} tok/s)")
    return tokens


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
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
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
    return serve_lm(arch, args.requests, args.prompt_len, args.new_tokens,
                    args.seed, args.device)


if __name__ == "__main__":
    main()
