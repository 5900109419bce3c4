"""Bit-window helper of the HTC1 step decoders (`ops/decode.py`).

Counterpart of `huffman_tpu/ops/bitops.py`.  Values the JAX package holds
as uint32 are int64 here, masked to 32 bits; the shift that can reach 32
keeps the JAX package's two-shift form.
"""

from __future__ import annotations

import torch

__all__ = ["extract_window32"]

_M32 = 0xFFFFFFFF


def extract_window32(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 32-bit window from absolute bit ``pos`` of an MSB-first u32 word
    stream, read from two words.

    words: (W,) int64 u32 values, with at least one zero pad word past the
    data; pos: int64 bit offsets (any shape).  A word index past the end
    reads the last word, as the JAX package's clamped gather does.
    Returns int64 u32 values shaped like ``pos``."""
    last = words.shape[0] - 1
    w = pos >> 5
    sh = pos & 31
    hi = words[w.clamp(0, last)]
    lo = words[(w + 1).clamp(0, last)]
    return ((hi << sh) & _M32) | ((lo >> 1) >> (31 - sh))
