"""mace [arXiv:2206.07697]: E(3)-equivariant, l_max = 2, correlation 3,
bfloat16 messages and features."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn.mace import MACEConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="mace", family="gnn",
    model_cfg=MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                         correlation=3, n_rbf=8,
                         dtype="bfloat16", remat=False),
    shapes=gnn_shapes(), opt=OptConfig(moment_dtype="float32"),
    source="arXiv:2206.07697"))
