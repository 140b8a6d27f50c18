"""llama3-405b [arXiv:2407.21783]: dense 126-layer GQA, 128k vocab, a
float8 KV cache (port of ``repro/configs/llama3_405b.py``).

The optimizer is factored (an Adafactor-style second moment, no first
moment, bfloat16 statistics and bfloat16 gradient accumulation), as the
reference's, which sized it for a pod's memory.
"""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="llama3-405b",
    family="lm-dense",
    model_cfg=LMConfig(
        name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
        n_kv_heads=8, d_head=128, d_ff=53248, vocab=128256,
        rope_theta=500000.0, dtype="bfloat16", param_dtype="bfloat16",
        remat=True, seq_parallel_residual=True,
        kv_cache_dtype="float8_e4m3fn"),
    shapes=lm_shapes(),
    opt=OptConfig(b1=0.0, moment_dtype="bfloat16", factored=True,
                  accum_dtype="bfloat16"),
    microbatches=4,
    source="arXiv:2407.21783",
))
