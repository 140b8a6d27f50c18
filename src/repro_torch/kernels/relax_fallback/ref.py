"""Plain PyTorch version of the relax_fallback kernel."""
from __future__ import annotations

import torch


def relax_fallback_ref(row_ptr, src_idx, col_idx, weights, vals, base,
                       max_pos: int = 8) -> torch.Tensor:
    """The kernel's function in tensor ops, as the reference's
    ``_relax_fallback`` folded into the probe's accumulator
    (``repro/traversal/semiring.py:120-131,155-159``): edge slot e of row
    ``src_idx[e]``, at position ``pos = e - row_ptr[src_idx[e]]``, offers
    ``vals[clip(col_idx[e])] + w[e]`` when ``max_pos <= pos < deg``; then

      base[v] = min(base[v], min of row v's offers)

    in place, with a 1-D ``index_reduce_`` (amin) over the masked [m, L]
    offers, so no scan runs down a column; returns ``base``. ``vals`` is
    float32[nf, L] (any nf >= 1); ``base`` is float32[n, L]."""
    m = col_idx.shape[0]
    n = base.shape[0]
    if m == 0 or n == 0:
        return base
    nf = vals.shape[0]
    row = src_idx.clamp(0, n - 1)
    pos = torch.arange(m, dtype=torch.int32, device=col_idx.device) \
        - row_ptr[row]
    deg = row_ptr[1:] - row_ptr[:-1]
    act = (pos >= max_pos) & (pos < deg[row])
    cand = vals[col_idx.clamp(0, nf - 1)] + weights.to(vals.dtype)[:, None]
    cand = torch.where(act[:, None], cand, float("inf"))
    return base.index_reduce_(0, row, cand, "amin")
