"""Interleaved-stream (ILS) layout constants and container parameters.

The layout contract is the JAX package's (`huffman_tpu/core/ils_ref.py`):

- A tile holds ``ILS_LANES = 1024`` streams and covers ``1024 * k`` bytes.
  Stream ``s`` owns the tile's u32 words ``{w : w % 1024 == s}``; symbol
  ``4i + j`` of the stream is byte ``j`` (little-endian) of its word ``i``.
- Each stream's codewords are packed MSB-first; payload row ``r`` of a tile
  holds word ``r`` of all 1024 streams.  Streams are zero-padded to the
  tile's even word count ``W_t`` (pairs of words are the transfer unit).
- Refill cadence v2, per body ``i`` of four symbols: the decoder refills a
  pair when ``valid <= 64`` (128-bit register, ``pptr`` starts at 2); the
  encoder emits a pair when ``used >= 64``, plus one final zero-padded
  pair.  ``mu_i = (i * snum) >> 16`` and the deviations of the refill
  pointer from it, per ``ILS_WIN``-body window, give the certified
  ``boffs``/``w_band`` stored in the container.
- With rotation on, stream ``(sub, lane)`` of body row ``r`` reads word
  ``((sub - r*ILS_ROT_SUB) % 8, (lane - r*ILS_ROT_LANE) % 128)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ILS_LANES",
    "ILS_WIN",
    "ILS_ROT_SUB",
    "ILS_ROT_LANE",
    "ils_n_win",
    "IlsParams",
    "ils_schedule_numer",
]

ILS_LANES = 1024  # streams per tile
ILS_WIN = 64  # body iterations per band-anchor window
# lane-decorrelation rotation constants (container v4 format parameters)
ILS_ROT_SUB = 3
ILS_ROT_LANE = 5


def ils_n_win(k: int) -> int:
    return -(-(k // 4) // ILS_WIN)


@dataclasses.dataclass(frozen=True)
class IlsParams:
    """Per-section schedule/layout parameters stored in the container."""

    k: int  # symbols per stream (multiple of 4)
    snum: int  # expected word-PAIRS per body iteration, 16.16 fixed point
    boffs: np.ndarray  # (n_tiles, n_win) int32 windowed band anchors (pairs)
    w_band: int  # refill window width in PAIRS
    w_cap: int  # row capacity per tile in words (even, >= max W_t)
    w_tiles: np.ndarray  # (n_tiles,) int32 actual rows per tile (even)
    n_tiles: int
    rot: bool = False  # lane-decorrelation rotation (see ILS_ROT_*)

    @property
    def row_starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.w_tiles)]).astype(np.int32)

    @property
    def total_rows(self) -> int:
        return int(self.w_tiles.sum())


def ils_schedule_numer(avg_bits_per_symbol: float) -> int:
    """16.16 fixed-point expected word PAIRS consumed per body iteration
    (4 symbols, 64-bit pairs)."""
    return max(int(round(avg_bits_per_symbol * 4.0 / 64.0 * 65536.0)), 1)


def _rot_src_index(k: int, inverse: bool = False) -> np.ndarray:
    """(k//4, ILS_LANES) flat word index each stream reads per row (or, for
    ``inverse``, the flat stream index each word position reads back)."""
    r = np.arange(k // 4)[:, None, None]
    sub = np.arange(8)[None, :, None]
    lane = np.arange(ILS_LANES // 8)[None, None, :]
    sgn = 1 if inverse else -1
    src_sub = (sub + sgn * r * ILS_ROT_SUB) % 8
    src_lane = (lane + sgn * r * ILS_ROT_LANE) % (ILS_LANES // 8)
    return (src_sub * (ILS_LANES // 8) + src_lane).reshape(k // 4, ILS_LANES)
