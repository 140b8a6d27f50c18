"""qwen1.5-32b [hf:Qwen/Qwen1.5-*]: dense 64 layers, MHA (kv = 40), QKV
bias, a float8 KV cache (port of ``repro/configs/qwen15_32b.py``)."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="qwen1.5-32b",
    family="lm-dense",
    model_cfg=LMConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, d_head=128, d_ff=27392, vocab=152064,
        rope_theta=1000000.0, qkv_bias=True, dtype="bfloat16",
        param_dtype="bfloat16", remat=True,
        kv_cache_dtype="float8_e4m3fn", attn_seq_pin=False),
    shapes=lm_shapes(),
    opt=OptConfig(moment_dtype="float32"),
    microbatches=8,
    source="hf:Qwen/Qwen1.5-0.5B (scaled family config)",
))
