"""The four LM-family input shapes shared by all five LM archs (port of
``repro/configs/lm_shapes.py``)."""
from __future__ import annotations

from repro_torch.configs.base import Shape

FULL_ATTN_SKIP = ("pure full-attention arch: 512k dense decode attention is "
                  "out of contract scope (sub-quadratic attention required); "
                  "see DESIGN.md §4")


def lm_shapes() -> tuple[Shape, ...]:
    return (
        Shape("train_4k", "train",
              dims=dict(seq_len=4096, global_batch=256)),
        Shape("prefill_32k", "prefill",
              dims=dict(seq_len=32768, global_batch=32)),
        Shape("decode_32k", "decode",
              dims=dict(seq_len=32768, global_batch=128)),
        Shape("long_500k", "decode",
              dims=dict(seq_len=524288, global_batch=1),
              skip_reason=FULL_ATTN_SKIP),
    )
