"""Import every ported architecture config (populates the registry).
The reference's five LM configs wait for ROADMAP A10 (d)."""
import repro_torch.configs.gin_tu      # noqa: F401
import repro_torch.configs.gcn_cora    # noqa: F401
import repro_torch.configs.mace_arch   # noqa: F401
import repro_torch.configs.egnn_arch   # noqa: F401
import repro_torch.configs.dien_arch   # noqa: F401
