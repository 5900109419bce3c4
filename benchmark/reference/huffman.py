"""Plain canonical Huffman tables for the benchmark's reference.

A frozen copy of the algorithms the reference needs, kept apart from the
program: the optimal length-limited code lengths of a histogram
(package-merge, the coin collector's method, with ties broken by the
stable order of (frequency, symbol)), the canonical code of a length
profile (length ascending, then symbol ascending), and a flat decode
table indexed by the next ``LUT_BITS`` bits of a stream; and what both
formats' references share: the byte histogram, the copy of an index array
to the device, and the count of bytes that differ.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHABET = 256
LUT_BITS = 16  # every format here limits codewords to 16 bits


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """(256,) uint8 optimal code lengths under ``max_len``; 0 marks an
    absent symbol, a lone symbol gets 1 bit."""
    freqs = np.asarray(freqs, np.int64)
    syms = np.nonzero(freqs)[0]
    n = len(syms)
    lengths = np.zeros(ALPHABET, np.uint8)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError(f"{n} symbols do not fit {max_len}-bit codes")
    order = np.argsort(freqs[syms], kind="stable")
    leaves = syms[order]
    w = freqs[leaves]
    eye = np.eye(n, dtype=np.int32)
    items_w, items_c = w.copy(), eye.copy()
    # from the deepest level up: pair adjacent items into packages and
    # merge them with a fresh row of leaves
    for _ in range(max_len - 1):
        p = len(items_w) & ~1
        all_w = np.concatenate([w, items_w[0:p:2] + items_w[1:p:2]])
        all_c = np.concatenate([eye, items_c[0:p:2] + items_c[1:p:2]])
        o = np.argsort(all_w, kind="stable")
        items_w, items_c = all_w[o], all_c[o]
    lengths[leaves] = items_c[: 2 * n - 2].sum(axis=0).astype(np.uint8)
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """(256,) int64 right-aligned canonical codes of a length profile."""
    lengths = np.asarray(lengths, np.int64)
    syms = np.nonzero(lengths)[0]
    order = np.lexsort((syms, lengths[syms]))
    codes = np.zeros(ALPHABET, np.int64)
    code, prev = 0, 0
    for i, s in enumerate(syms[order]):
        ln = int(lengths[s])
        code = 0 if i == 0 else (code + 1) << (ln - prev)
        prev = ln
        codes[s] = code
    return codes


def kraft_ok(lengths: np.ndarray, max_len: int) -> bool:
    """True where the profile is a complete prefix code within max_len
    (a lone 1-bit symbol counts as complete)."""
    ls = np.asarray(lengths, np.int64)
    ls = ls[ls > 0]
    if ls.size == 0 or ls.max() > max_len:
        return ls.size == 0
    total = int(np.sum(np.int64(1) << (max_len - ls)))
    return total == (1 << max_len) or (ls.size == 1 and ls[0] == 1)


def decode_lut(lengths: np.ndarray):
    """(sym, len) int64 arrays of 2**LUT_BITS entries: the symbol whose
    codeword prefixes each LUT_BITS-bit window, and its length (0 where
    no codeword does)."""
    lengths = np.asarray(lengths, np.int64)
    codes = canonical_codes(lengths)
    lut_sym = np.zeros(1 << LUT_BITS, np.int64)
    lut_len = np.zeros(1 << LUT_BITS, np.int64)
    for s in np.nonzero(lengths)[0]:
        ln = int(lengths[s])
        lo = int(codes[s]) << (LUT_BITS - ln)
        hi = lo + (1 << (LUT_BITS - ln))
        lut_sym[lo:hi] = s
        lut_len[lo:hi] = ln
    return lut_sym, lut_len


def byte_histogram(data: torch.Tensor) -> np.ndarray:
    """(256,) int64 counts of the bytes of ``data``."""
    return torch.bincount(data.reshape(-1), minlength=ALPHABET).cpu().numpy()


def on_device(a, device) -> torch.Tensor:
    """An int64 copy of a host array on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def diff_bytes(got: torch.Tensor, want: torch.Tensor) -> int:
    """Bytes that differ, plus the difference in length."""
    got, want = got.reshape(-1), want.reshape(-1).to(got.device)
    n = min(got.numel(), want.numel())
    return int((got[:n] != want[:n]).sum()) + abs(got.numel() - want.numel())
