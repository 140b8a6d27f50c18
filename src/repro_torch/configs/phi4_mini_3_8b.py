"""phi4-mini-3.8b [arXiv:2412.08905; hf]: dense 32-layer GQA transformer
(port of ``repro/configs/phi4_mini_3_8b.py``)."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="phi4-mini-3.8b",
    family="lm-dense",
    model_cfg=LMConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_head=128, d_ff=8192, vocab=200064,
        rope_theta=10000.0, dtype="bfloat16", param_dtype="bfloat16",
        remat=True),
    shapes=lm_shapes(),
    opt=OptConfig(moment_dtype="float32"),
    microbatches=8,
    source="arXiv:2412.08905",
))
