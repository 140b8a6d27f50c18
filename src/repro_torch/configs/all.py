"""Import every architecture config (populates the registry)."""
import repro_torch.configs.phi4_mini_3_8b        # noqa: F401
import repro_torch.configs.qwen15_32b            # noqa: F401
import repro_torch.configs.llama3_405b           # noqa: F401
import repro_torch.configs.granite_moe_1b_a400m  # noqa: F401
import repro_torch.configs.qwen3_moe_30b_a3b     # noqa: F401
import repro_torch.configs.gin_tu                # noqa: F401
import repro_torch.configs.gcn_cora              # noqa: F401
import repro_torch.configs.mace_arch             # noqa: F401
import repro_torch.configs.egnn_arch             # noqa: F401
import repro_torch.configs.dien_arch             # noqa: F401
