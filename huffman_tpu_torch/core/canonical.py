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

__all__ = [
    "CodeTable",
    "TwoLevelTable",
    "canonical_code_table",
    "chain_spec",
    "build_flat_lut",
    "build_two_level_table",
]


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
    idx = np.repeat(cs << (b - ls), widths) + _ranges(widths)
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


def _ranges(widths: np.ndarray) -> np.ndarray:
    """Concatenated [0, w) ranges, one per w in widths."""
    total = int(widths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.cumsum(widths) - widths
    return np.arange(total, dtype=np.int64) - np.repeat(starts, widths)


@dataclasses.dataclass(frozen=True)
class TwoLevelTable:
    """Two-level L1/L2 decode table (the reference's `get_table.cpp`
    layout).

    Codes of at most prefix_bits bits fill the 2^prefix_bits L1 table; a
    longer code sits in the L2 subtable of its prefix_bits-bit prefix, whose
    width is the longest code sharing that prefix minus prefix_bits."""

    prefix_bits: int
    boundary_code: int  # first L1 index owned by long codes
    l1_sym: np.ndarray  # (2^prefix_bits,) uint8
    l1_len: np.ndarray  # (2^prefix_bits,) uint8
    ptr_table: np.ndarray  # (n_long_prefixes,) uint32: (width << 16) | offset
    l2_sym: np.ndarray  # (l2_size,) uint8
    l2_len: np.ndarray  # (l2_size,) uint8


def build_two_level_table(table: CodeTable, prefix_bits: int = 10) -> TwoLevelTable:
    p = int(prefix_bits)
    l1_sym = np.zeros(1 << p, np.uint8)
    l1_len = np.zeros(1 << p, np.uint8)
    syms = table.symtab
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)

    short = ls <= p
    if np.any(short):
        widths = np.int64(1) << (p - ls[short])
        idx = np.repeat(cs[short] << (p - ls[short]), widths) + _ranges(widths)
        reps = np.repeat(np.arange(int(short.sum())), widths)
        l1_sym[idx] = syms[short][reps]
        l1_len[idx] = ls[short][reps].astype(np.uint8)

    if not np.any(~short):
        return TwoLevelTable(
            prefix_bits=p, boundary_code=1 << p, l1_sym=l1_sym, l1_len=l1_len,
            ptr_table=np.zeros(0, np.uint32), l2_sym=np.zeros(0, np.uint8),
            l2_len=np.zeros(0, np.uint8))

    # canonical order puts every long code's prefix at or above every short
    # code's L1 index; one subtable per prefix from the boundary up, unused
    # prefixes as zero-width entries so a prefix indexes (prefix - boundary)
    long_ls, long_cs, long_syms = ls[~short], cs[~short], syms[~short]
    long_prefix = long_cs >> (long_ls - p)
    boundary = int(long_prefix.min())
    ptr_entries, sym_parts, len_parts = [], [], []
    off = 0
    for pref in range(boundary, int(long_prefix.max()) + 1):
        sel = long_prefix == pref
        if not np.any(sel):
            ptr_entries.append(off)
            continue
        sub_ls, sub_cs = long_ls[sel], long_cs[sel]
        width = int(sub_ls.max()) - p
        ssym = np.zeros(1 << width, np.uint8)
        slen = np.zeros(1 << width, np.uint8)
        starts = (sub_cs & ((np.int64(1) << (sub_ls - p)) - 1)) << (
            p + width - sub_ls)
        widths = np.int64(1) << (p + width - sub_ls)
        idx = np.repeat(starts, widths) + _ranges(widths)
        reps = np.repeat(np.arange(sub_ls.size), widths)
        ssym[idx] = long_syms[sel][reps]
        slen[idx] = sub_ls[reps].astype(np.uint8)
        ptr_entries.append((width << 16) | off)
        sym_parts.append(ssym)
        len_parts.append(slen)
        off += 1 << width
    return TwoLevelTable(
        prefix_bits=p, boundary_code=boundary, l1_sym=l1_sym, l1_len=l1_len,
        ptr_table=np.asarray(ptr_entries, np.uint32),
        l2_sym=np.concatenate(sym_parts), l2_len=np.concatenate(len_parts))
