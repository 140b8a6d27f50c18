"""Packed bitmap operations.

Same layout as ``repro.core.bitmap`` (paper Listing 1): bit ``v`` lives in
word ``v >> 5`` at position ``v & 31``, least significant bit first.

Words are stored as int32 bit patterns, because torch's uint32 has no
``~``, ``<<``, ``>>`` or ``scatter_reduce`` on the CPU. A word viewed as
uint32 equals the reference's word. ``>>`` on int32 is arithmetic, so every
shift that extracts a bit is followed by ``& 1``. The CUDA kernels read the
same words as ``uint32_t``.
"""
from __future__ import annotations

import torch

WORD_BITS = 32
_WORD_SHIFT = 5
_BIT_MASK = 0x1F


def num_words(n: int) -> int:
    """Number of 32-bit words to hold ``n`` bits."""
    return (n + WORD_BITS - 1) // WORD_BITS


def pack(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool[n] mask into int32[ceil(n/32)] words (LSB-first)."""
    n = mask.shape[0]
    nw = num_words(n)
    padded = torch.zeros(nw * WORD_BITS, dtype=torch.int64, device=mask.device)
    padded[:n] = mask
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    words = (padded.view(nw, WORD_BITS) << shifts).sum(dim=1)
    return words.to(torch.int32)  # values below 2**32 wrap to their bit pattern


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack int32 words into a bool[n] mask."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def test(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Test bits at vertex ids ``idx`` (any shape). Out-of-range ids -> False.

    The vectorised form of the paper's
    ``(frontier->start[v >> 5] >> (v & 0x1F)) & 1``.
    """
    nbits = words.shape[0] * WORD_BITS
    in_range = (idx >= 0) & (idx < nbits)
    safe = idx.clamp(0, nbits - 1)
    w = words[safe >> _WORD_SHIFT]
    return (((w >> (safe & _BIT_MASK)) & 1) == 1) & in_range


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total number of set bits (int32 scalar)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    per_word = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return per_word.sum().to(torch.int32)


def set_bits(words: torch.Tensor, idx: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Set bits for vertex ids ``idx`` where ``valid`` (scatter-OR).

    Ids are clamped into range as in the reference, so an id past the end
    sets the last bit.
    """
    nbits = words.shape[0] * WORD_BITS
    safe = idx.reshape(-1).clamp(0, nbits - 1).to(torch.int64)
    if valid is not None:
        safe = safe[valid.reshape(-1)]
    hit = torch.zeros(nbits, dtype=torch.bool, device=words.device)
    hit[safe] = True
    return words | pack(hit)
