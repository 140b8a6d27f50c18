"""Import every ported architecture config (populates the registry).
The reference's other nine architectures wait for ROADMAP A10."""
import repro_torch.configs.gcn_cora  # noqa: F401
