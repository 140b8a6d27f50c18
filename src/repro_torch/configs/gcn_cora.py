"""gcn-cora [arXiv:1609.02907]: 2-layer GCN, sym-normalised SpMM."""
from repro_torch.configs.base import Arch, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn.gcn import GCNConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="gcn-cora", family="gnn",
    model_cfg=GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, norm="sym"),
    shapes=gnn_shapes(), opt=OptConfig(moment_dtype="float32"),
    source="arXiv:1609.02907"))
