"""Plain PyTorch version of the msbfs_probe kernel."""
from __future__ import annotations

import torch


def probe_rounds(starts, deg, need_words, col_idx, frontier_words,
                 max_pos: int = 8):
    """Yield (live bool[n, W], acc int32[n, W]) for each probe round pos <
    max_pos: the word planes that gather in this round, and the accumulator
    after it. A plane is live while it has needed lanes unserved and pos <
    deg (retirement is per plane)."""
    nf = frontier_words.shape[0]
    m = col_idx.shape[0]
    acc = torch.zeros_like(need_words)
    if m == 0:
        return
    for pos in range(max_pos):
        live = ((need_words & ~acc) != 0) & (pos < deg)[:, None]
        vadj = col_idx[(starts + pos).clamp(0, m - 1)]
        inside = (vadj >= 0) & (vadj < nf)
        words = torch.where(inside[:, None],
                            frontier_words[vadj.clamp(0, nf - 1)], 0)
        acc = acc | torch.where(live, words, 0)
        yield live, acc


def msbfs_probe_ref(starts, deg, need_words, col_idx, frontier_words,
                    max_pos: int = 8) -> torch.Tensor:
    """The kernel's function in tensor ops: acc int32[n, W].

    For each vertex and word plane, OR the frontier words of neighbours
    ``col_idx[start + pos]``, pos < min(deg, max_pos), while the plane still
    has needed lanes unserved: retirement is per plane, as in the kernel and
    in ``repro.kernels.msbfs_probe.ref``. ``frontier_words`` is int32[nf, W]
    (nf may differ from n); a neighbour id outside [0, nf) gathers
    nothing."""
    acc = torch.zeros_like(need_words)
    for _, acc in probe_rounds(starts, deg, need_words, col_idx,
                               frontier_words, max_pos):
        pass
    return acc
