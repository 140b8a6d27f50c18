"""Batched LM serving: prefill and greedy decode into a KV cache written in
place (port of ``examples/serve_lm.py``).

  python -m repro_torch.examples.serve_lm [--device cpu]

Serves the reduced qwen3-moe-30b-a3b (``configs/reduced.py``: 2 layers,
8 experts top-2): 4 requests, 32-token prompts, 16 new tokens each.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.reduced import reduce_arch
from repro_torch.launch.serve import serve_lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)

    arch = reduce_arch("qwen3-moe-30b-a3b")
    print(f"serving reduced {arch.arch_id} "
          f"({arch.model_cfg.param_count():,} params, MoE "
          f"{arch.model_cfg.moe.num_experts} experts top-"
          f"{arch.model_cfg.moe.top_k})")
    tokens = serve_lm(arch, requests=4, prompt_len=32, new_tokens=16,
                      device=args.device)
    return dict(arch=arch.arch_id, tokens=tokens)


if __name__ == "__main__":
    main()
