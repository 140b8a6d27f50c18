"""Plain PyTorch version of the fused row-OR kernel."""
from __future__ import annotations

import torch


def segment_or_rows_ref(row_ptr, col_idx, frontier, mask, sel=None,
                        base=None, row_active=None,
                        min_pos: int = 0) -> torch.Tensor:
    """The kernel's function, composed from the plain ``packed.segment_or``
    as the reference's packed steps compose theirs
    (``repro/core/packed.py:175-198``): edge slot e of row v at position
    ``pos = e - row_ptr[v]`` contributes ``frontier[clip(col_idx[e])] & sel``
    when row v is active and ``pos >= min_pos``; then

      out[v] = base[v] | (mask[v] & OR of row v's contributions).

    ``sel=None`` selects every lane, ``base=None`` is 0 and
    ``row_active=None`` makes every row active."""
    from repro_torch.core.packed import segment_or  # packed imports ops
    n = row_ptr.shape[0] - 1
    m = col_idx.shape[0]
    nf = frontier.shape[0]
    e = torch.arange(m, dtype=torch.int32, device=col_idx.device)
    # the row owning each slot; slots outside [row_ptr[0], row_ptr[-1]) own
    # none and stay inactive
    row = torch.searchsorted(row_ptr, e, right=True) - 1
    owned = (row >= 0) & (row < n)
    row = row.clamp(0, max(n - 1, 0))
    act = owned & (e - row_ptr[row] >= min_pos)
    if row_active is not None:
        act = act & (row_active[row] != 0)
    contrib = frontier[col_idx.clamp(0, nf - 1)]
    if sel is not None:
        contrib = contrib & sel
    contrib = torch.where(act[:, None], contrib, 0)
    out = segment_or(contrib, row_ptr) & mask
    return out if base is None else base | out
