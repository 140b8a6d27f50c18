"""egnn [arXiv:2102.09844]: E(n)-equivariant GNN, 4 layers."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn.egnn import EGNNConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="egnn", family="gnn",
    model_cfg=EGNNConfig(name="egnn", n_layers=4, d_hidden=64),
    shapes=gnn_shapes(), opt=OptConfig(moment_dtype="float32"),
    source="arXiv:2102.09844"))
