"""Plain PyTorch version of the bottom_up_probe kernel."""
from __future__ import annotations

import torch

from repro_torch.core import bitmap


def probe_rounds(starts, deg, unvisited, col_idx, frontier_words,
                 max_pos: int = 8):
    """Yield (live, vadj, hit) for each probe round pos < max_pos: the
    vertices that gather in this round (unvisited, not yet found, pos <
    deg), the neighbour each reads, and which live vertices hit."""
    m = col_idx.shape[0]
    if m == 0:
        return
    unv = unvisited != 0
    found = torch.zeros_like(unv)
    for pos in range(max_pos):
        live = unv & ~found & (pos < deg)
        vadj = col_idx[(starts + pos).clamp(0, m - 1)]
        hit = live & bitmap.test(frontier_words, vadj)
        found = found | hit
        yield live, vadj, hit


def bottom_up_probe_ref(starts, deg, unvisited, parent, col_idx,
                        frontier_words, max_pos: int = 8):
    """The kernel's function in tensor ops. Returns (found int32, parent)."""
    found = torch.zeros_like(unvisited, dtype=torch.bool)
    par = parent.clone()
    for _, vadj, hit in probe_rounds(starts, deg, unvisited, col_idx,
                                     frontier_words, max_pos):
        par = torch.where(hit, vadj, par)
        found = found | hit
    return found.to(torch.int32), par
