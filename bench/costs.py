"""The yardstick of the kernel rooflines: the H100's peaks, and for each
kernel the least bytes and operations its work needs, whatever implements
it, counted from the arguments of one launch.

The cost functions are those of the port's kernel smoke harness
(``chip_smoke.py``: ``bound_ms``, ``lane_probe_cost``, ``row_or_cost``,
``relax_cost``, ``fallback_cost``), copied so that the program can change
without moving the yardstick. The work counters (``*_work``) are plain torch
over the launch's arguments; they import nothing of the program.

Each ``*_launch`` function takes the arguments of the program's op as the
engine calls it and returns the launch's bound in seconds: the larger of
its bytes over the HBM bandwidth and its operations over the 32-bit rate.
"""
from __future__ import annotations

import torch

# H100 SXM, NVIDIA's data sheet, at the full 700 W: HBM3 bytes/s, and the
# 32-bit rate outside the tensor cores, used for these kernels' integer and
# float32 operations (the card's int32 rate is not higher).
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / MEM_BYTES_PER_S, ops / OPS_PER_S)


def lane_probe_cost(n, w, rows, probes, words):
    # reads the need words, the bounds of the rows with a needed lane
    # (row_ptr, at most all of it), one neighbour id per round in which any
    # plane gathers, each gathered frontier word (at most the whole
    # frontier); writes acc
    nbytes = (8 * n * w + min(4 * (n + 1), 8 * rows) + 4 * probes
              + 4 * min(words, n * w))
    ops = 4 * n * w + 3 * words
    return bound_s(nbytes, ops)


def row_or_cost(n, w, edges, has_base, has_active, nf):
    # reads: row_ptr, the row flags, each edge slot's neighbour id once,
    # each row's frontier words once (at most the whole frontier), mask and
    # base; writes: out
    nbytes = (4 * (n + 1) + (4 * n if has_active else 0) + 4 * edges
              + 4 * min(edges, nf) * w + 4 * n * w * (3 if has_base else 2))
    ops = 2 * edges * w + 2 * n * w
    return bound_s(nbytes, ops)


def relax_cost(n, lanes, slots, finite, rows):
    # reads: row_ptr, one weight per live slot, the neighbour id of each of
    # the ``finite`` live slots with a finite weight, and each distinct lane
    # row those gather, once; writes: acc
    nbytes = (4 * (n + 1) + 4 * (slots + finite) + 4 * lanes * rows
              + 4 * n * lanes)
    return bound_s(nbytes, 2 * finite * lanes)


def fallback_cost(n, lanes, slots, finite, rows, residue_rows):
    # reads: row_ptr, one weight per residue slot, the neighbour id of each
    # of the ``finite`` ones with a finite weight, each distinct lane row
    # those gather, once, and the base of the residue rows; writes: those
    # rows
    nbytes = (4 * (n + 1) + 4 * (slots + finite) + 4 * lanes * rows
              + 8 * residue_rows * lanes)
    return bound_s(nbytes, 2 * finite * lanes)


def planes(words: torch.Tensor) -> torch.Tensor:
    """Lane words as the int32 planes the kernels read (64-bit words as
    their two halves)."""
    return words.view(torch.int32) if words.dtype == torch.int64 else words


def lane_probe_work(row_ptr, col_idx, frontier, need, max_pos):
    """(rows with a needed lane, rounds in which any plane gathers, plane
    gathers) of the bounded probe: a plane gathers in round ``pos`` while
    it has needed lanes unserved and ``pos`` < the row's degree."""
    need, frontier = planes(need), planes(frontier)
    starts = row_ptr[:-1].long()
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    nf, m = frontier.shape[0], col_idx.shape[0]
    acc = torch.zeros_like(need)
    probes = words = 0
    for pos in range(max_pos):
        live = ((need & ~acc) != 0) & (pos < deg)[:, None]
        nb = col_idx[(starts + pos).clamp(0, m - 1)].long().clamp(0, nf - 1)
        acc = acc | torch.where(live, frontier[nb], 0)
        probes += int(live.any(dim=-1).sum())
        words += int(live.sum())
    rows = int((need != 0).any(dim=-1).sum())
    return rows, probes, words


def msbfs_probe_launch(row_ptr, col_idx, frontier_words, need_words,
                       max_pos=8):
    """Bound of one ``msbfs_probe`` launch (B3)."""
    n, w = need_words.shape[0], planes(need_words).shape[1]
    return lane_probe_cost(n, w, *lane_probe_work(
        row_ptr, col_idx, frontier_words, need_words, max_pos))


def segment_or_launch(row_ptr, col_idx, frontier, mask, sel=None, base=None,
                      row_active=None, min_pos=0):
    """Bound of one ``segment_or_rows`` launch (X1): every slot at
    position >= ``min_pos`` of every active row."""
    n, w = mask.shape[0], planes(mask).shape[1]
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    span = (deg - min_pos).clamp(min=0)
    if row_active is not None:
        span = torch.where(row_active.bool(), span, 0)
    return row_or_cost(n, w, int(span.sum()), base is not None,
                       row_active is not None, frontier.shape[0])


def _cached(t: torch.Tensor, key, make):
    """``make()``, kept on tensor ``t`` under ``key``: the count pass meets
    the same graph and the same few weight sets in every launch, and a
    value kept on the tensor lives no longer than the tensor."""
    cache = t.__dict__.setdefault("_bench_costs", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _slot_pos(row_ptr, m):
    """Each slot's position in its row."""
    def make():
        ar = torch.arange(m, device=row_ptr.device)
        rows = torch.searchsorted(row_ptr, ar.to(row_ptr.dtype),
                                  right=True) - 1
        return ar - row_ptr[rows].long()
    return _cached(row_ptr, ("pos", m), make)


def _relax_slots(row_ptr, col_idx, weights, max_pos, residue):
    """(slots, finite ones, distinct neighbours those gather) of each
    row's first ``max_pos`` slots, or of the rest (``residue``)."""
    def make():
        pos = _slot_pos(row_ptr, col_idx.shape[0])
        slots = pos >= max_pos if residue else pos < max_pos
        fin = slots & torch.isfinite(weights)
        return (int(slots.sum()), int(fin.sum()),
                int(torch.unique(col_idx[fin]).numel()))
    return _cached(weights, ("slots", row_ptr.data_ptr(), max_pos, residue),
                   make)


def semiring_relax_launch(row_ptr, col_idx, weights, vals, max_pos=8):
    """Bound of one ``semiring_relax`` launch (B4): each row's first
    ``max_pos`` slots."""
    return relax_cost(row_ptr.shape[0] - 1, vals.shape[1],
                      *_relax_slots(row_ptr, col_idx, weights, max_pos,
                                    False))


def relax_fallback_launch(row_ptr, src_idx, col_idx, weights, vals, base,
                          max_pos=8):
    """Bound of one ``relax_fallback`` launch (X2): the slots past each
    row's first ``max_pos``."""
    deg = row_ptr[1:] - row_ptr[:-1]
    return fallback_cost(row_ptr.shape[0] - 1, vals.shape[1],
                         *_relax_slots(row_ptr, col_idx, weights, max_pos,
                                       True),
                         int((deg > max_pos).sum()))


def roofline_pct(t, op: str, kernels: tuple[str, ...]):
    """A kernel's share of its roofline in the traced window: the summed
    bounds of the op's launches (counted in a pass of their own over the
    same requests) over the device time of the kernels whose names contain
    one of ``kernels``. None where either is missing."""
    bounds = t.bounds.get(op)
    dev_s = sum(s for name, s in t.kernel_s.items()
                if any(k in name for k in kernels))
    if not bounds or dev_s <= 0:
        return None
    return 100.0 * sum(bounds) / dev_s
