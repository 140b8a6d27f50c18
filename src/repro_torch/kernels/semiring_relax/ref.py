"""Plain PyTorch version of the semiring_relax kernel."""
from __future__ import annotations

import torch


def semiring_relax_ref(starts, deg, col_idx, weights, vals,
                       max_pos: int = 8) -> torch.Tensor:
    """The kernel's function in tensor ops, as ``repro.kernels.
    semiring_relax.ref``: per row, the min over its first ``max_pos``
    neighbours of ``vals[neighbour] + weight`` (+inf where nothing
    relaxes). ``vals`` is float32[nf, L] (any nf >= 1), or float32[nf] as
    L = 1 (returned flat)."""
    flat = vals.dim() == 1
    if flat:
        vals = vals[:, None]
    m = col_idx.shape[0]
    nf = vals.shape[0]
    w = weights.to(torch.float32)
    acc = torch.full((starts.shape[0], vals.shape[1]), float("inf"),
                     dtype=torch.float32, device=vals.device)
    for pos in range(max_pos if m else 0):
        live = (pos < deg)[:, None]
        idx = (starts + pos).clamp(0, m - 1)
        vadj = col_idx[idx].clamp(0, nf - 1)
        cand = vals[vadj] + w[idx][:, None]
        acc = torch.minimum(acc, torch.where(live, cand, float("inf")))
    return acc[:, 0] if flat else acc
