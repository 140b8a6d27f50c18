"""gin-tu [arXiv:1810.00826]: GIN, 5 layers, sum aggregation, learnable
eps."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn.gin import GINConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="gin-tu", family="gnn",
    model_cfg=GINConfig(name="gin-tu", n_layers=5, d_hidden=64),
    shapes=gnn_shapes(), opt=OptConfig(moment_dtype="float32"),
    source="arXiv:1810.00826"))
