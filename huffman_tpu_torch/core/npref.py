"""Pure-NumPy reference codec — the test oracle of the HTC1 path.

Copies of `huffman_tpu/core/npref.py`: byte histogram, the MSB-first u32
bit stream, the per-segment (gap, count) metadata and two decoders.  The
histogram also counts a tensor where it lies.  As in the JAX package, the
histogram of a host array of at least 64 KiB and the bit stream run in the
native host module (`huffman_tpu_torch/native.py`) where it builds; its
results are the NumPy code's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ALPHABET_SIZE, SEG_BITS, UNIT_BITS
from ..utils import trace
from .canonical import CodeTable, build_flat_lut

__all__ = [
    "histogram",
    "encode_bits",
    "segment_metadata",
    "decode_bits_serial",
    "decode_segments_np",
]


def histogram(data) -> np.ndarray:
    """(256,) int64 byte histogram of a uint8 array or tensor.

    A tensor is counted where it lies (`ops/histogram_kernels.py::
    byte_counts`: the kernel on a card) and only the 256 counts come back
    to the host, so a device-resident input is never copied whole."""
    if isinstance(data, torch.Tensor):
        from ..ops.histogram_kernels import byte_counts

        return trace.to_host(byte_counts(data), "histogram").numpy()
    data = np.asarray(data, dtype=np.uint8)
    from .. import native

    if data.size >= (1 << 16) and native.available():
        return native.histogram(data)
    return np.bincount(data.reshape(-1), minlength=ALPHABET_SIZE).astype(np.int64)


def encode_bits(data: np.ndarray, table: CodeTable):
    """Encode bytes into an MSB-first uint32 unit stream.

    Returns (words, total_bits); ``words`` has one zero pad unit appended so
    decoders may read one unit past the end."""
    data = np.asarray(data, dtype=np.uint8)
    if data.size == 0:
        return np.zeros(1, np.uint32), 0
    from .. import native

    if native.available():
        return native.encode_bits(data, table.codes, table.lengths)
    lens = table.lengths[data].astype(np.int64)
    if np.any(lens == 0):
        raise ValueError("input contains a symbol absent from the code table")
    codes = table.codes[data].astype(np.uint64)
    ends = np.cumsum(lens)
    total_bits = int(ends[-1])
    offs = ends - lens  # exclusive start bit of each codeword
    words = np.zeros((total_bits + UNIT_BITS - 1) // UNIT_BITS + 1, np.uint32)
    left = codes << (64 - lens).astype(np.uint64)  # left-justified in 64
    both = left >> (offs % UNIT_BITS).astype(np.uint64)
    w0 = offs // UNIT_BITS
    np.add.at(words, w0, (both >> np.uint64(32)).astype(np.uint32))
    np.add.at(words, w0 + 1, (both & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return words, total_bits


def segment_metadata(data: np.ndarray, table: CodeTable, seg_bits: int = SEG_BITS):
    """Per-segment (gaps uint8, counts int32, total_bits).

    gap[k] = bit offset within segment k of the first codeword starting in
    it; count[k] = number of codewords starting inside segment k, which
    covers bits [k*seg_bits, (k+1)*seg_bits)."""
    data = np.asarray(data, dtype=np.uint8)
    lens = table.lengths[data].astype(np.int64)
    ends = np.cumsum(lens)
    total_bits = int(ends[-1]) if data.size else 0
    offs = ends - lens
    n_segs = max((total_bits + seg_bits - 1) // seg_bits, 0)
    bounds = np.arange(n_segs, dtype=np.int64) * seg_bits
    idx = np.searchsorted(offs, bounds, side="left")
    offs_pad = np.concatenate([offs, [total_bits]])
    gaps = np.where(bounds < total_bits, offs_pad[idx] - bounds, 0)
    counts = np.concatenate([idx[1:], [data.size]]) - idx
    return gaps.astype(np.uint8), counts.astype(np.int32), total_bits


def decode_bits_serial(
    words: np.ndarray, total_bits: int, table: CodeTable, n_symbols: int | None = None
) -> np.ndarray:
    """Bit-serial decode via the flat LUT — the trusted slow path."""
    b = table.max_len_present
    if b == 0:
        return np.zeros(0, np.uint8)
    lut_sym, lut_len = build_flat_lut(table, b)
    bits = np.unpackbits(
        np.ascontiguousarray(words[: (total_bits + 31) // 32])
        .view(np.uint8).reshape(-1, 4)[:, ::-1]
    )
    # pad bits so a full window read never overruns
    bits = np.concatenate([bits[:total_bits], np.zeros(b, np.uint8)])
    weights = 1 << np.arange(b - 1, -1, -1)
    out = []
    pos = 0
    while pos < total_bits:
        window = int(bits[pos : pos + b] @ weights)
        ln = int(lut_len[window])
        out.append(lut_sym[window])
        pos += ln
        if ln == 0:
            raise ValueError("corrupt stream: zero-length code")
    res = np.asarray(out, np.uint8)
    if n_symbols is not None and res.size != n_symbols:
        raise ValueError(f"decoded {res.size} symbols, expected {n_symbols}")
    return res


def decode_segments_np(
    words: np.ndarray,
    gaps: np.ndarray,
    counts: np.ndarray,
    table: CodeTable,
    seg_bits: int = SEG_BITS,
) -> np.ndarray:
    """Vectorized-across-segments NumPy decode: every segment advances one
    symbol per step from bit ``k*seg_bits + gap[k]``; output is the
    concatenation of each segment's ``count[k]`` symbols."""
    b = table.max_len_present
    lut_sym, lut_len = build_flat_lut(table, b)
    n_segs = len(gaps)
    if n_segs == 0:
        return np.zeros(0, np.uint8)
    words64 = np.concatenate([words.astype(np.uint64), np.zeros(1, np.uint64)])
    pos = np.arange(n_segs, dtype=np.int64) * seg_bits + gaps.astype(np.int64)
    remaining = counts.astype(np.int64).copy()
    out_cols = []
    for _ in range(int(remaining.max())):
        active = remaining > 0
        w = pos >> 5
        sh = (pos & 31).astype(np.uint64)
        window = ((words64[w] << np.uint64(32)) | words64[w + 1]) >> (
            np.uint64(32) - sh
        )
        window = (window & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        idx = (window >> np.uint32(32 - b)).astype(np.int64)
        out_cols.append(np.where(active, lut_sym[idx], 0).astype(np.uint8))
        pos += np.where(active, lut_len[idx].astype(np.int64), 0)
        remaining -= active
    padded = (np.stack(out_cols) if out_cols
              else np.zeros((0, n_segs), np.uint8))
    out_offs = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    k = np.arange(int(out_offs[-1]), dtype=np.int64)
    seg_id = np.searchsorted(out_offs, k, side="right") - 1
    return padded[k - out_offs[seg_id], seg_id]
