"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24
layers, MoE of 32 experts top-8, d_ff 512 an expert (port of
``repro/configs/granite_moe_1b_a400m.py``)."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="granite-moe-1b-a400m",
    family="lm-moe",
    model_cfg=LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_head=64, d_ff=0, vocab=49155,
        rope_theta=10000.0, dtype="bfloat16", param_dtype="bfloat16",
        remat=True,
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512)),
    shapes=lm_shapes(),
    opt=OptConfig(moment_dtype="float32"),
    microbatches=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
