"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48 layers, MoE of 128
experts top-8 (port of ``repro/configs/qwen3_moe_30b_a3b.py``)."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="qwen3-moe-30b-a3b",
    family="lm-moe",
    model_cfg=LMConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=0, vocab=151936,
        rope_theta=1000000.0, dtype="bfloat16", param_dtype="bfloat16",
        remat=True,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768)),
    shapes=lm_shapes(),
    opt=OptConfig(moment_dtype="float32"),
    microbatches=8,
    source="hf:Qwen/Qwen3-30B-A3B",
))
