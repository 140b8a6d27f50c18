"""Packed bit-lane primitives of the multi-source BFS engines.

Port of ``repro.core.packed``. Bit ``r % LANE_WORD_BITS`` of lane word
``r // LANE_WORD_BITS`` at row ``v`` means "root r's traversal has reached
v". ``LANE_WORD_BITS`` is read from the environment at import, as the
reference reads it: 32 (the default) or 64. Words are stored as the bit
patterns of the reference's unsigned words in ``word_dtype()`` (int32 or
int64), as ``core/bitmap.py`` stores its words: a word viewed as unsigned
equals the reference's word. ``>>`` on signed words is arithmetic, so every
bit extraction ends in ``& 1``; the CUDA kernels read the words as
``uint32_t``. A 64-bit word column reaches them as its int32 view, which is
the reference's ``split_u64_words`` layout (plane 2k word k's low half,
plane 2k+1 its high half; ``kernels/common.py::word_planes``).

The step functions take the graph as a ``CSRGraph`` and assume, as the
reference does, that ``row_ptr`` indexes the caller's rows, ``col_idx``
holds neighbour ids into ``frontier``, and ``frontier`` may have more rows
than ``visited``.

Where the reference decides on the device (the ``lax.cond`` skips, the
direction switch, the queue claims), the port decides on the host from the
per-lane counters the engines read back once per layer: ``select_direction``
and ``queue_claims`` take and return numpy arrays.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.csr import CSRGraph
from repro_torch.core.hybrid import switch_direction
from repro_torch.kernels.common import word_planes
from repro_torch.kernels.msbfs_probe.ops import msbfs_probe
from repro_torch.kernels.segment_or.ops import segment_or_rows
from repro_torch.obs import spans

# the width of a lane word, from the environment as in the reference; there
# is no switch at run time (a test of the other width runs in a child)
LANE_WORD_BITS = int(os.environ.get("LANE_WORD_BITS", "32"))
if LANE_WORD_BITS not in (32, 64):
    raise ValueError(
        f"LANE_WORD_BITS must be 32 or 64, got {LANE_WORD_BITS}")
MODES = ("hybrid", "topdown", "bottomup")


def word_dtype() -> torch.dtype:
    """The lane words' tensor dtype: int32 or int64, the bit patterns of
    the reference's uint32 or uint64 words."""
    return torch.int64 if LANE_WORD_BITS == 64 else torch.int32


def host_word_dtype() -> type:
    """The reference's host dtype of a lane word, for the surfaces that
    give words as unsigned: np.uint32 or np.uint64."""
    return np.uint64 if LANE_WORD_BITS == 64 else np.uint32


def signed_words(a: np.ndarray) -> np.ndarray:
    """Host lane words (unsigned, or int64 sums of distinct bits) as the
    bit patterns of ``word_dtype()``, ready for ``torch.from_numpy``."""
    signed = np.int64 if LANE_WORD_BITS == 64 else np.int32
    return np.asarray(a).astype(host_word_dtype()).view(signed)


def num_lane_words(num_roots: int) -> int:
    return (num_roots + LANE_WORD_BITS - 1) // LANE_WORD_BITS


def pack_lanes(mask: torch.Tensor) -> torch.Tensor:
    """Pack bool[..., R] lane masks into ``word_dtype()``[..., W] words
    (LSB-first).

    Words are built in int64: a sum of distinct bits is their OR, so at 64
    bits it is already the word (lane 63 sets the sign bit), and at 32 bits
    it wraps to int32 (lane 31 sets the sign bit)."""
    r = mask.shape[-1]
    w = num_lane_words(r)
    lanes = torch.zeros(mask.shape[:-1] + (w * LANE_WORD_BITS,),
                        dtype=torch.int64, device=mask.device)
    lanes[..., :r] = mask
    shifts = torch.arange(LANE_WORD_BITS, dtype=torch.int64,
                          device=mask.device)
    words = (lanes.view(mask.shape[:-1] + (w, LANE_WORD_BITS))
             << shifts).sum(dim=-1)
    return words.to(word_dtype())


def pack_lanes_np(mask: np.ndarray) -> np.ndarray:
    """``pack_lanes`` of a host bool[R] mask, as a host array of W words
    in ``word_dtype()``'s numpy twin."""
    r = mask.shape[-1]
    lanes = np.zeros(num_lane_words(r) * LANE_WORD_BITS, np.int64)
    lanes[:r] = mask
    words = (lanes.reshape(-1, LANE_WORD_BITS)
             << np.arange(LANE_WORD_BITS, dtype=np.int64)).sum(axis=-1)
    return signed_words(words)


def unpack_lanes(words: torch.Tensor, num_roots: int) -> torch.Tensor:
    """Unpack lane words [..., W] into bool[..., R].

    64-bit words are unpacked over their int32 view: lane r is bit r % 32 of
    half-word r // 32 in both layouts, so the result is the same and the
    [..., 2W, 32] intermediate is the 32-bit engine's, not an int64 one of
    twice the bytes."""
    halves = word_planes(words.contiguous())
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (halves[..., None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (-1,))
    return flat[..., :num_roots].to(torch.bool)


def depth_slice_words(depth: torch.Tensor, max_depth: int,
                      min_depth: int = 0) -> torch.Tensor:
    """Per-lane depths int32[n, R] (-1 unreached) re-packed into lane words
    over the band ``min_depth <= depth <= max_depth``: ``max_depth=k`` is
    the packed k-hop neighbourhood of every lane root, ``min_depth =
    max_depth = d`` the layer-d frontier."""
    return pack_lanes((depth >= min_depth) & (depth <= max_depth))


def segment_or(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-CSR-row bitwise OR of [m, W] edge-lane words -> [n, W], in the
    words' own dtype (int32 or int64; an int64 column is ORed as its two
    int32 halves, which an OR leaves exact).

    The plain version of the reference's segmented-OR scan: torch has no
    scan with an OR combine and no OR mode in ``scatter_reduce``, so this
    counts each bit with a prefix sum over the edge slots and reads a row's
    count as ``csum[row end] - csum[row start]``. Empty rows, and trailing
    rows whose start equals m, give 0; slots past ``row_ptr[-1]``
    (distributed edge-slab padding) lie in no row and reach no output. One
    bit at a time, so every prefix sum is a 1-D scan (a scan down the
    columns of an [m, 32] array runs one thread per column on the GPU)."""
    if vals.dtype == torch.int64:
        return segment_or(word_planes(vals.contiguous()),
                          row_ptr).view(torch.int64)
    m, w = vals.shape
    lo, hi = row_ptr[:-1].long(), row_ptr[1:].long()
    out = torch.zeros((row_ptr.shape[0] - 1, w), dtype=torch.int64,
                      device=vals.device)
    csum = torch.zeros(m + 1, dtype=torch.int32, device=vals.device)
    for k in range(w):
        for b in range(32):
            torch.cumsum((vals[:, k] >> b) & 1, dim=0, dtype=torch.int32,
                         out=csum[1:])
            out[:, k] |= ((csum[hi] - csum[lo]) > 0).long() << b
    return out.to(torch.int32)  # bit 31 wraps to the sign bit


def probe_xla(g: CSRGraph, frontier: torch.Tensor, need: torch.Tensor,
              max_pos: int) -> torch.Tensor:
    """The reference's plain word-packed MAX_POS probe (``probe_xla``).

    For each vertex, OR the lane words of its first ``max_pos`` neighbours,
    retiring the gather once every needed lane of the VERTEX has found a
    parent (the kernel retires per word plane; ``acc & need`` is the same
    either way). The caller masks the result with ``need``."""
    m = g.m
    starts = g.row_ptr[:-1]
    deg = g.deg
    acc = torch.zeros_like(need)
    if m == 0:
        return acc
    for pos in range(max_pos):
        live = ((need & ~acc) != 0).any(dim=-1) & (pos < deg)
        vadj = g.col_idx[(starts + pos).clamp(0, m - 1)]
        acc = acc | torch.where(live[:, None], frontier[vadj], 0)
    return acc


def bottomup_packed_step(g: CSRGraph, frontier: torch.Tensor,
                         visited: torch.Tensor, bu_sel: torch.Tensor,
                         max_pos: int) -> torch.Tensor:
    """Packed bottom-up: the ``msbfs_probe`` kernel, then the fallback over
    positions >= max_pos for the rows with unserved lanes (the ``residue``),
    both on the device. Returns the new frontier bits of the bottom-up lanes
    (already & ~visited).

    The fallback is the fused ``segment_or`` kernel with ``residue`` as its
    active rows, so it needs no ``any(residue)`` read-back: with no residue
    every row is inactive and the output is ``found``, as in the reference's
    ``lax.cond`` skip."""
    need = ~visited & bu_sel
    acc = msbfs_probe(g.row_ptr, g.col_idx, frontier, need, max_pos)
    found = acc & need
    residue = ((need & ~found) != 0).any(dim=-1) & (g.deg > max_pos)
    return segment_or_rows(g.row_ptr, g.col_idx, frontier, mask=need,
                           base=found, row_active=residue, min_pos=max_pos)


def topdown_packed_step(g: CSRGraph, frontier: torch.Tensor,
                        visited: torch.Tensor,
                        td_sel: torch.Tensor) -> torch.Tensor:
    """Packed top-down: each row ORs its neighbours' frontier words (masked
    to the top-down lanes) and keeps the unvisited bits; on the symmetric
    Graph500 graphs that is exactly the top-down expansion."""
    return segment_or_rows(g.row_ptr, g.col_idx, frontier, mask=~visited,
                           sel=td_sel)


def lane_counters(g: CSRGraph, frontier_b: torch.Tensor,
                  visited_b: torch.Tensor):
    """Per-lane (e_f, v_f, e_u) int32 from unpacked bool[n, R] state."""
    deg = g.deg[:, None]
    e_f = torch.where(frontier_b, deg, 0).sum(dim=0, dtype=torch.int32)
    v_f = frontier_b.sum(dim=0, dtype=torch.int32)
    e_u = torch.where(visited_b, 0, deg).sum(dim=0, dtype=torch.int32)
    return e_f, v_f, e_u


def select_direction(mode: str, topdown_prev, e_f, v_f, e_u, n: int,
                     alpha: float, beta: float, lanes: int) -> np.ndarray:
    """Per-lane TD/BU decision for one layer, on the host: bool[lanes]."""
    if mode == "topdown":
        return np.ones(lanes, bool)
    if mode == "bottomup":
        return np.zeros(lanes, bool)
    return switch_direction(topdown_prev, e_f, v_f, e_u, n, alpha, beta)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a GPU it goes from pinned memory
    without blocking, so it does not wait for the queued work as a plain
    copy does (PyTorch synchronises the stream after a pageable copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload(a: np.ndarray, device: torch.device, name: str) -> torch.Tensor:
    """A host array on ``device`` by a plain copy from pageable memory,
    which on a GPU waits for the queued work: traced as the sync span
    ``name`` and counted in ``host_syncs`` (``obs/spans.py``)."""
    with spans.host_sync(name):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_host(t: torch.Tensor, name: str) -> np.ndarray:
    """A device tensor read back to the host as a numpy array, which waits
    for the queued work: traced as the sync span ``name`` and counted in
    ``host_syncs`` (``obs/spans.py``)."""
    with spans.host_sync(name):
        return t.cpu().numpy()


def dispatch_packed_step(g: CSRGraph, frontier: torch.Tensor,
                         visited: torch.Tensor, td_sel: np.ndarray,
                         bu_sel: np.ndarray, mode: str,
                         max_pos: int) -> torch.Tensor:
    """The packed TD/BU step(s) of one layer under the lane selectors.

    The selectors are host arrays of W words (``pack_lanes_np``), built
    from the counters the engine read back: a direction with no lane
    selected is skipped on the host, as the reference skips it with
    ``lax.cond``."""
    dev = frontier.device
    if mode == "topdown":
        return topdown_packed_step(g, frontier, visited,
                                   to_device(td_sel, dev))
    if mode == "bottomup":
        return bottomup_packed_step(g, frontier, visited,
                                    to_device(bu_sel, dev), max_pos)
    new = torch.zeros_like(visited)
    if td_sel.any():
        new = new | topdown_packed_step(g, frontier, visited,
                                        to_device(td_sel, dev))
    if bu_sel.any():
        new = new | bottomup_packed_step(g, frontier, visited,
                                         to_device(bu_sel, dev), max_pos)
    return new


def queue_claims(lane_qidx: np.ndarray, next_root: int, queued: int,
                 queue: np.ndarray):
    """Idle lanes (``lane_qidx >= capacity``) claim consecutive pending
    queue slots in lane order. Returns host ``(claim bool[L], cand
    int32[L], root int32[L])``; slot and root mean something only where
    ``claim``."""
    cap = queue.shape[0]
    idle = lane_qidx >= cap
    rank = np.cumsum(idle.astype(np.int32)) - 1
    cand = (next_root + rank).astype(np.int32)
    claim = idle & (cand < queued)
    root = queue[np.clip(cand, 0, cap - 1)]
    return claim, cand, root


def adaptive_lane_pool(pending: int, n: int, m: int, max_lanes: int = 256,
                       state_budget_bytes: int = 64 << 20) -> int:
    """The bit-lane pool width from the queue depth and the graph's degree.

    * never wider than the pending root count, rounded up to a full lane
      word;
    * average degree sets a tier: sparse graphs run deep sweeps and earn
      wide pools, dense graphs (average degree >= 16) stay near 64 lanes;
    * capped so that the packed state (frontier and visited words plus the
      int32 depth column per lane) stays inside ``state_budget_bytes``.

    Returns a positive multiple of ``LANE_WORD_BITS``."""
    if n < 1:
        raise ValueError(f"need a non-empty graph, got n={n}")
    pending = max(int(pending), 1)
    avg_deg = m / n
    if avg_deg >= 16.0:
        tier_cap = 64
    elif avg_deg >= 4.0:
        tier_cap = 128
    else:
        tier_cap = max_lanes
    per_lane = 4.25 * n  # frontier + visited n/8 bytes each, depth 4n
    budget_cap = max(int(state_budget_bytes / per_lane), 1)
    want = max(1, min(pending, tier_cap, budget_cap, max_lanes))
    return LANE_WORD_BITS * num_lane_words(want)
