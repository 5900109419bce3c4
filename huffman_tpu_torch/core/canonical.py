"""Canonical Huffman code assignment (host-side NumPy).

The same table math as `huffman_tpu/core/canonical.py`, kept as its own copy
so that this package imports nothing of the JAX package.  Codes, decode
limits and the grouped compare-chain spec must stay bit-identical to it:
they decide the container bytes (the table is stored as lengths only and
rebuilt by every reader).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import ALPHABET_SIZE, MAX_CODEWORD_LENGTH

__all__ = ["CodeTable", "canonical_code_table", "chain_spec", "build_flat_lut"]


@dataclasses.dataclass(frozen=True)
class CodeTable:
    """Canonical Huffman code table (host-side, NumPy arrays).

    Attributes:
      lengths: (256,) uint8 codeword length per symbol; 0 = absent.
      codes: (256,) uint32 right-aligned canonical codeword per symbol.
      max_len: the L the table was built for (codeword lengths are <= L).
      symtab: (n,) uint8 symbols in canonical order (length asc, symbol asc).
      counts: (L+1,) int32 number of codes of each length (index = length).
      first_code: (L+1,) uint32 first canonical code value of each length.
      offsets: (L+1,) int32 rank (index into symtab) of the first symbol of
        each length.
      lim_left: (L+1,) uint32 left-justified decode limits; for a 32-bit
        window, true length = 1 + #{l in [1, L-1] : window >= lim_left[l]}.
    """

    lengths: np.ndarray
    codes: np.ndarray
    max_len: int
    symtab: np.ndarray
    counts: np.ndarray
    first_code: np.ndarray
    offsets: np.ndarray
    lim_left: np.ndarray

    @property
    def num_symbols(self) -> int:
        return int(self.symtab.shape[0])

    @property
    def min_len(self) -> int:
        present = self.lengths[self.lengths > 0]
        return int(present.min()) if present.size else 0

    @property
    def max_len_present(self) -> int:
        present = self.lengths[self.lengths > 0]
        return int(present.max()) if present.size else 0


def canonical_code_table(
    lengths: np.ndarray, max_len: int = MAX_CODEWORD_LENGTH
) -> CodeTable:
    """Assign canonical codes from a valid length profile.

    Canonical order is (length ascending, symbol ascending); codes within the
    order are ``code[i] = (code[i-1] + 1) << (len[i] - len[i-1])``.
    """
    lengths = np.asarray(lengths, dtype=np.uint8)
    if lengths.shape != (ALPHABET_SIZE,):
        raise ValueError("lengths must be shape (256,)")
    if int(lengths.max(initial=0)) > max_len:
        raise ValueError("length exceeds max_len")

    syms = np.nonzero(lengths > 0)[0]
    ls = lengths[syms].astype(np.int64)
    order = np.lexsort((syms, ls))
    symtab = syms[order].astype(np.uint8)
    sorted_lens = ls[order]

    codes = np.zeros(ALPHABET_SIZE, np.uint32)
    counts = np.zeros(max_len + 1, np.int32)
    first_code = np.zeros(max_len + 1, np.uint32)
    offsets = np.zeros(max_len + 1, np.int32)
    lim_left = np.zeros(max_len + 1, np.uint32)

    if len(symtab) > 0:
        kraft = int(np.sum(1 << (max_len - sorted_lens)))
        if kraft > (1 << max_len):
            raise ValueError("lengths violate Kraft inequality")

        c = 0
        prev = int(sorted_lens[0])
        codes[symtab[0]] = 0
        for i in range(1, len(symtab)):
            l = int(sorted_lens[i])
            c = (c + 1) << (l - prev)
            prev = l
            codes[symtab[i]] = c

        for l in range(1, max_len + 1):
            counts[l] = int(np.sum(sorted_lens == l))
        offsets[1:] = np.cumsum(counts[:-1].astype(np.int64))[:].astype(np.int32)
        nc = 0
        for l in range(1, max_len + 1):
            first_code[l] = nc
            nc = (nc + int(counts[l])) << 1
        # left-justified limits (first_code + count) << (32 - l); only levels
        # below the deepest occupied one are ever compared, so the 2^32
        # overflow at a saturated deepest level is clamped defensively
        for l in range(1, max_len + 1):
            v = (int(first_code[l]) + int(counts[l])) << (32 - l)
            lim_left[l] = min(v, 0xFFFFFFFF)

    return CodeTable(
        lengths=lengths,
        codes=codes,
        max_len=max_len,
        symtab=symtab,
        counts=counts,
        first_code=first_code,
        offsets=offsets,
        lim_left=lim_left,
    )


def build_flat_lut(table: CodeTable, lut_bits: int | None = None):
    """Single-level decode LUT: 2^lut_bits entries of (symbol, length);
    every codeword of length l fills ``2**(lut_bits-l)`` consecutive rows.

    Returns (lut_sym (2^B,) uint8, lut_len (2^B,) uint8)."""
    b = int(lut_bits if lut_bits is not None else table.max_len)
    if table.max_len_present > b:
        raise ValueError("lut_bits smaller than longest codeword")
    lut_sym = np.zeros(1 << b, np.uint8)
    lut_len = np.zeros(1 << b, np.uint8)
    syms = table.symtab
    if syms.size == 0:
        return lut_sym, lut_len
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)
    widths = np.int64(1) << (b - ls)
    reps = np.repeat(np.arange(len(syms)), widths)
    # concatenated [0, w) ranges, one per codeword
    ranges = np.arange(int(widths.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(widths) - widths, widths)
    idx = np.repeat(cs << (b - ls), widths) + ranges
    lut_sym[idx] = syms[reps]
    lut_len[idx] = ls[reps].astype(np.uint8)
    return lut_sym, lut_len


def chain_spec(table: CodeTable) -> tuple[tuple[int, int], ...]:
    """Grouped compare-chain spec for the canonical length decode.

    ``len = min_len + sum(weight for (l, w) if window >= lim_left[l])``: one
    ``(level, weight)`` pair per DISTINCT limit over ``[min_len,
    max_len_present)`` (levels without codewords share their neighbour's
    limit).  Equal to the dense per-level count, which the decode kernel
    evaluates; kept for parity with the JAX package's decode argument.
    """
    lo, hi = table.min_len, table.max_len_present
    out = []
    l = lo
    while l < hi:
        j = l
        while j + 1 < hi and int(table.counts[j + 1]) == 0:
            j += 1
        out.append((j, j - l + 1))
        l = j + 1
    return tuple(out)
