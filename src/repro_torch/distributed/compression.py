"""Collective-payload compression: the frontier-word and lane-value codecs.

Port of the frontier-word and value halves of
``repro.distributed.compression``. The 2-D exchange ships per-device slices
of packed lane words every layer, and sparse frontiers are mostly zero
words. ``compress_words`` packs the nonzero
words of a slice into (flat index, payload) pairs inside a fixed
``budget``-slot buffer, and ``decompress_words`` scatters them back. Pad
slots carry ``(0, 0)``, so decompression is exact whenever ``count <=
budget``; the exchange falls back to the dense form otherwise
(``sparse_budget``, ``DENSE_THRESHOLD``).

Words are the port's signed bit patterns (int32, or int64 at 64-bit lane
words). The reference max-scatters its unsigned payloads, which a signed
word with the top bit set would lose against a pad slot's 0; the port
scatters only the nonzero payloads, which gives the same bits.

The value codec (``values_finite``, ``compress_values``,
``decompress_values``) is the float twin for the distributed SSSP engines'
MIN exchanges: ``inf`` is the MIN identity, so a slice ships its finite
entries only, and decompression is a min-scatter onto an ``inf``
background.

The gradient codec (``init_error_state``, ``compress_tree``,
``decompress_tree``, ``psum_compressed``) quantises each gradient tensor
to int8 under one float32 scale (its largest magnitude over 127), with
error feedback: the part the int8 payload could not carry is added to the
next step's gradient. ``round`` is round-half-even, as the reference's.
A tree is a nest of dicts with tensor leaves; a quantised leaf is the pair
``(int8 payload, float32 scale)``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["DENSE_THRESHOLD", "compress_tree", "compress_values",
           "compress_words", "decompress_tree", "decompress_values",
           "decompress_words", "init_error_state", "psum_compressed",
           "sparse_budget", "values_finite", "words_nnz", "wire_bytes"]

# the sparse form wins while at most this fraction of words is nonzero: a
# sparse slot costs an int32 index and the word, so at 4-byte words the
# break-even is 50 % density; 25 % leaves room for the count header and
# keeps the switch conservative at 8-byte words
DENSE_THRESHOLD = 0.25

_IDX_BYTES = 4      # int32 flat word index per sparse slot
_COUNT_BYTES = 4    # int32 nonzero-count header per sparse message


def sparse_budget(num_words: int, threshold: float = DENSE_THRESHOLD) -> int:
    """Sparse-buffer slots for a ``num_words``-word slice: at most
    ``floor(num_words * threshold)`` nonzero words (at least 1). A slice
    with more nonzero words ships dense."""
    if num_words < 1:
        raise ValueError(f"need at least one word, got {num_words}")
    return max(1, int(num_words * threshold))


def words_nnz(words: torch.Tensor) -> torch.Tensor:
    """Nonzero-word count of a word slice (any shape): int32 scalar."""
    return (words.reshape(-1) != 0).sum(dtype=torch.int32)


def compress_words(words: torch.Tensor, budget: int):
    """Pack the nonzero words of ``words`` (any shape, flattened row-major)
    into a ``budget``-slot sparse buffer.

    Returns ``(idx int32[budget], payload[budget], count int32)``: the
    first ``min(count, budget)`` slots hold the flat indices and words of
    the leading nonzero words in ascending index order, pad slots hold
    ``(0, 0)``. ``count`` is the true nonzero total and may exceed
    ``budget``. No host sync: each nonzero word's slot is its rank among
    the nonzero words (a prefix sum), and words past the budget go to a
    discarded slot."""
    flat = words.reshape(-1)
    return _pack_slots(flat != 0, flat, budget, 0)


def decompress_words(idx: torch.Tensor, payload: torch.Tensor,
                     num_words: int) -> torch.Tensor:
    """Scatter a sparse buffer back into a flat ``num_words`` word array.

    Real slots hold unique indices and nonzero words; pad slots hold
    ``(0, 0)`` and are dropped, so a real word at index 0 survives whatever
    its sign."""
    target = torch.where(payload != 0, idx.long(), num_words)
    flat = torch.zeros(num_words + 1, dtype=payload.dtype,
                       device=payload.device)
    flat.scatter_(0, target, payload)
    return flat[:num_words]


def wire_bytes(count, num_words: int, budget: int, itemsize: int):
    """Bytes a slice costs on the wire under the density switch: the sparse
    form (count header and an index and a word per nonzero word) while
    ``count <= budget``, every word otherwise. ``count`` may be a tensor,
    and the result is then an int32 tensor, or a host int."""
    sparse = _COUNT_BYTES + count * (_IDX_BYTES + itemsize)
    dense = num_words * itemsize
    if isinstance(count, torch.Tensor):
        return torch.where(count <= budget, sparse, dense).to(torch.int32)
    return sparse if count <= budget else dense


def values_finite(vals: torch.Tensor) -> torch.Tensor:
    """Finite-entry count of a float value slice (any shape): int32
    scalar. ``inf`` is the MIN identity, so the finite entries are the only
    payload worth shipping."""
    return torch.isfinite(vals.reshape(-1)).sum(dtype=torch.int32)


def _pack_slots(keep: torch.Tensor, flat: torch.Tensor, budget: int,
                pad_value):
    """The slots of ``compress_words`` and ``compress_values``: the flat
    indices and entries of the leading ``keep`` entries, in ascending index
    order, in a ``budget``-slot buffer padded with ``(0, pad_value)``, and
    the true ``keep`` count. A prefix sum gives each kept entry its slot,
    and entries past the budget go to a discarded slot: no host sync."""
    total = flat.shape[0]
    if budget < 1 or budget > total:
        raise ValueError(f"budget must be in [1, {total}], got {budget}")
    rank = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    slot = torch.where(keep & (rank < budget), rank, budget)
    dev = flat.device
    idx = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, slot, torch.arange(total, dtype=torch.int32, device=dev))
    payload = torch.full((budget + 1,), pad_value, dtype=flat.dtype,
                         device=dev)
    payload.scatter_(0, slot, flat)
    count = keep.sum(dtype=torch.int32)
    valid = torch.arange(budget, device=dev) < count
    return (torch.where(valid, idx[:budget], 0),
            torch.where(valid, payload[:budget], pad_value), count)


def compress_values(vals: torch.Tensor, budget: int):
    """Pack the finite entries of a float value slice (any shape, flattened
    row-major) into a ``budget``-slot sparse buffer: the float twin of
    ``compress_words``, where an entry is empty when it is ``inf``.

    Returns ``(idx int32[budget], payload[budget], count int32)``: the
    first ``min(count, budget)`` slots hold the flat indices and values of
    the leading finite entries in ascending index order (the reference's
    stable argsort order), pad slots hold ``(0, inf)``. ``count`` is the
    true finite total and may exceed ``budget``: the exchange then ships
    the dense form."""
    flat = vals.reshape(-1)
    return _pack_slots(torch.isfinite(flat), flat, budget, float("inf"))


def decompress_values(idx: torch.Tensor, payload: torch.Tensor,
                      num_values: int) -> torch.Tensor:
    """Min-scatter a sparse value buffer onto an all-``inf`` background of
    ``num_values`` entries: a pad slot ``(0, inf)`` leaves slot 0 as it
    is."""
    flat = torch.full((num_values,), float("inf"), dtype=payload.dtype,
                      device=payload.device)
    return flat.index_reduce_(0, idx.long(), payload, "amin")


# --------------------------------------------------------- gradient codec


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nests of dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_error_state(grads):
    """Zero float32 error feedback shaped like each gradient."""
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)


def _scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def _quant_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quant(x: torch.Tensor):
    """(int8 payload, float32 scale) of a float32 tensor."""
    scale = _scale(x)
    return _quant_with(x, scale), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, error_state):
    """-> (quantised tree of (int8, scale), new error state): each leaf
    quantises ``grad + error`` and keeps what the payload lost."""
    def one(g, e):
        x = g.to(torch.float32) + e
        q, scale = _quant(x)
        return (q, scale), x - _dequant(q, scale)
    pairs = _tree_map(one, grads, error_state)
    return (_tree_map(lambda p: p[0], pairs),
            _tree_map(lambda p: p[1], pairs))


def decompress_tree(qtree):
    """The float32 tree of a quantised one."""
    return _tree_map(lambda qs: _dequant(*qs), qtree)


def psum_compressed(grads, error_state, group=None):
    """int8 error-feedback sum over the ranks of ``group`` (default: the
    whole process group): each leaf's scale is all-reduced (MAX) so every
    rank quantises and dequantises alike, the int8 payloads are summed as
    int32 (no overflow), and the sum is dequantised in the gradient's dtype.
    Returns (summed gradients, new error state)."""
    def one(g, e):
        x = g.to(torch.float32) + e
        scale = _scale(x)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quant_with(x, scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return ((total.to(torch.float32) * scale).to(g.dtype),
                x - _dequant(q, scale))
    pairs = _tree_map(one, grads, error_state)
    return (_tree_map(lambda p: p[0], pairs),
            _tree_map(lambda p: p[1], pairs))
