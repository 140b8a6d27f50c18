"""dien [arXiv:1809.03672]: the sequential-behaviour CTR / recsys arch,
trained over 8 microbatches; served and used for retrieval."""
from repro_torch.configs.base import Arch, Shape, register
from repro_torch.models.recsys.dien import DIENConfig
from repro_torch.optim.adamw import OptConfig

ARCH = register(Arch(
    arch_id="dien", family="recsys",
    model_cfg=DIENConfig(
        name="dien", embed_dim=18, seq_len=100, gru_dim=108,
        mlp_dims=(200, 80), n_items=1_000_000, n_cats=1_000,
        n_profiles=100_000, use_aux_loss=True),
    shapes=(
        Shape("train_batch", "train", dims=dict(batch=65536)),
        Shape("serve_p99", "serve", dims=dict(batch=512)),
        Shape("serve_bulk", "serve", dims=dict(batch=262144)),
        Shape("retrieval_cand", "retrieval",
              dims=dict(batch=1, n_candidates=1_000_000)),
    ),
    opt=OptConfig(moment_dtype="float32"),
    microbatches=8,
    source="arXiv:1809.03672",
))
