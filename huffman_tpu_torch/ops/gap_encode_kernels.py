"""HTC1 encode kernels B4b-B4d: wrappers, plain versions, launch counts.

Counterpart of `huffman_tpu/ops/pallas/gap_encode_kernel.py`
(`encode_blocks_pallas`), bit-identical to it and to
`ops/encode.py::encode_block`.  Routing as in `ops/ils_kernels.py`: a CUDA
tensor launches the kernel of ``csrc/gap_encode.cu`` or raises, a CPU
tensor runs the plain version.  A block is cut into rows of
``ROW_BYTES = 128`` input bytes:

- `gap_row_pack` (B4b; the input relayout B4a and B3's encode use are its
  addressing): each row packed MSB-first into ``cap_words`` u32 words,
  with its bit count; a CUDA block packs `row_pack_tile`'s R rows through
  shared-memory tiles;
- `gap_row_meta` (B4c): per segment, the number of codewords starting in
  it and its first start, from the input rows and the code lengths (the
  starts are not stored); a CUDA block takes `meta_tile`'s R rows and
  their window of segments;
- `gap_place_bits` (B4d): each row's bits written at its block-local start
  bit of the output, 8 CUDA lanes a row, 16-byte quads;
- `encode_blocks`: the three, with the per-block cumsum of row bits and the
  gap formula between them as plain tensor code (the JAX package's XLA
  glue).  The TPU's VMEM geometry (`_geometry`, `_flush_window`, chunk
  plans) and its int32 global bit offsets are not carried over.

B4b and B4c take an optional ``n_bytes``, a (G,) int32 byte count per HTC1
block: bytes at or past a block's count are no symbols (no bits, no
codeword start), its last row may be partial and rows past it give 0
bits.  With it `encode_blocks` encodes blocks of any size B >= 1 (the rows
are the blocks zero-padded to whole rows), where the JAX package sends
blocks that are not a multiple of 128 bytes through XLA's `encode_block`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from .ils_kernels import (
    _M32,
    _check,
    _launched,
    _lib,
    _same_device,
    _stream,
    _to_i32,
    _u32,
    _use_kernel,
)

__all__ = [
    "ROW_BYTES",
    "row_cap_words",
    "row_pack_tile",
    "meta_tile",
    "row_starts",
    "gap_row_pack",
    "gap_row_pack_plain",
    "gap_row_meta",
    "gap_row_meta_plain",
    "gap_place_bits",
    "gap_place_bits_plain",
    "encode_blocks",
    "reset_launch_counts",
    "launch_counts",
]

ROW_BYTES = 128  # input bytes per row
ROW_WORDS = ROW_BYTES // 4
_INT32_MAX = (1 << 31) - 1
PACK_ROWS = 128  # rows of a B4b block
META_MAX_ROWS = 512  # rows of a B4c block, at most
# B4c's window bytes, at most: with its static 1 KB length table, under the
# 48 KB a CUDA block gets without opting in
_META_SMEM = 47104


def row_cap_words(max_len: int) -> int:
    """u32 words a row of 128 codewords of at most max_len bits needs,
    rounded to whole 64-bit pairs as in the JAX package."""
    return 2 * -(-ROW_BYTES * max_len // 64)


def row_pack_tile(cap_words: int) -> tuple[int, int]:
    """(rows per block, dynamic shared-memory bytes) of B4b: tiles of the
    block's input (pitch 33 words) and packed words (cap_words + 1), each
    pitch odd in words.  At most 50,176 bytes (cap_words 64);
    ``csrc/gap_encode.cu`` checks the same sum."""
    return PACK_ROWS, 4 * PACK_ROWS * (ROW_WORDS + 1 + cap_words + 1)


def meta_tile(seg_bits: int, max_len: int) -> tuple[int, int, int]:
    """(rows, window segments, dynamic shared-memory bytes) of a B4c block:
    the most rows, a power of two up to 512, whose window (the segments R
    rows of max_len-bit codes can span, ceil(R * 128 * max_len / seg_bits)
    + 1) holds in 47,104 bytes at two ints a segment.  R is 512 at seg_bits
    >= 256 for every max_len and 16 at seg_bits 8, max_len 16;
    ``csrc/gap_encode.cu`` checks the same window."""
    rows = META_MAX_ROWS
    while True:
        window = -(-rows * ROW_BYTES * max_len // seg_bits) + 1
        if 8 * window <= _META_SMEM or rows == 1:
            return rows, window, 8 * window
        rows //= 2


def _ptr(x):
    """A tensor's device address for a launcher, NULL for None."""
    return None if x is None else x.data_ptr()


def _low_bits(x, n):
    """The low n bits of x (n in [0, 32])."""
    return x & ((1 << n) - 1)


def _row_codes(rows, enc):
    """Each symbol's (len << 20) | code entry, (n_rows, 128) int64."""
    return enc.to(torch.int64)[rows.view(torch.uint8).to(torch.int64)]


def row_starts(rows, enc):
    """Each symbol's start bit within its row, (n_rows, 128) int64: the
    exclusive cumsum of the rows' code lengths (a byte the table lacks
    has length 0 and starts where the next symbol does)."""
    ln = _row_codes(rows, enc) >> 20
    return torch.cumsum(ln, 1) - ln


def _row_symbols(n_rows, n_bytes, device):
    """(n_rows, 128) bool, the bytes that are symbols: every byte without
    byte counts, else those before their HTC1 block's count (the G blocks
    of n_rows / G rows each)."""
    pos = torch.arange(ROW_BYTES, device=device)[None, :]
    if n_bytes is None:
        return pos < ROW_BYTES
    rows_b = n_rows // max(n_bytes.numel(), 1)
    r = torch.arange(n_rows, device=device)
    rest = n_bytes.to(torch.int64)[r // rows_b] - (r % rows_b) * ROW_BYTES
    return pos < rest[:, None]


def _check_n_bytes(n_bytes, n_rows, rows_per_block, ref):
    """n_bytes: None, or (G,) int32 on ref's device, G = n_rows /
    rows_per_block."""
    if n_bytes is None:
        return
    _check("n_bytes", n_bytes, torch.int32)
    if n_bytes.dim() != 1 or n_bytes.numel() * rows_per_block != n_rows:
        raise ValueError(f"n_bytes must be (G,) for G blocks of "
                         f"{rows_per_block} rows, got {tuple(n_bytes.shape)} "
                         f"for {n_rows} rows")
    _same_device(ref, n_bytes)


# ----------------------------------------------------------------------
# B4b: row pack
# ----------------------------------------------------------------------
def gap_row_pack_plain(rows, enc, *, cap_words, n_bytes=None):
    n_rows = rows.shape[0]
    e = _row_codes(rows, enc)
    e = torch.where(_row_symbols(n_rows, n_bytes, rows.device), e, 0)
    ln = e >> 20
    left = ((e & 0xFFFF) << (32 - ln)) & _M32  # ln == 0 gives 0
    ends = torch.cumsum(ln, 1)
    starts = ends - ln
    sh = starts & 31
    w0 = starts >> 5
    # the spare last word takes what a row of cap_words cannot hold
    pay = torch.zeros((n_rows, cap_words + 1), dtype=torch.int64,
                      device=rows.device)
    pay.scatter_add_(1, w0.clamp(max=cap_words), left >> sh)
    pay.scatter_add_(1, (w0 + 1).clamp(max=cap_words),
                     _low_bits(left, sh) << (32 - sh))
    return _to_i32(pay[:, :cap_words]), ends[:, -1].to(torch.int32)


def gap_row_pack(rows, enc, *, cap_words, n_bytes=None):
    """Pack each row of (n_rows, 32) int32 input words (128 bytes,
    little-endian within a word) with the (256,) int32 table of
    ``(len << 20) | code`` (`ils_kernels.ils_enc_tabs`).  n_bytes: None
    (every byte a symbol) or a (G,) int32 byte count for the rows taken as
    G blocks of n_rows / G rows; a byte at or past its block's count adds
    no bits.

    Returns (pay (n_rows, cap_words) int32 — MSB-first u32 words, zero past
    the row's bits —, bits (n_rows,) int32)."""
    _check("rows", rows, torch.int32)
    if rows.dim() != 2 or rows.shape[1] != ROW_WORDS:
        raise ValueError(f"rows must be (n_rows, {ROW_WORDS}), got "
                         f"{tuple(rows.shape)}")
    _check("enc", enc, torch.int32, (256,))
    _same_device(rows, enc)
    n_rows = rows.shape[0]
    block_rows = 0
    if n_bytes is not None:
        block_rows = n_rows // n_bytes.numel() if n_bytes.numel() else 0
        _check_n_bytes(n_bytes, n_rows, block_rows, rows)
    if not _use_kernel(rows):
        return gap_row_pack_plain(rows, enc, cap_words=cap_words,
                                  n_bytes=n_bytes)
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        # the kernel reads each row with 16-byte loads
        raise ValueError("rows must be contiguous and 16-byte aligned")
    dev = rows.device
    pay = torch.empty((n_rows, cap_words), dtype=torch.int32, device=dev)
    bits = torch.empty(n_rows, dtype=torch.int32, device=dev)
    if n_rows == 0:
        return pay, bits
    tile_rows, smem = row_pack_tile(cap_words)
    rc = _lib("gap_encode").gap_row_pack_launch(
        rows.data_ptr(), enc.data_ptr(), _ptr(n_bytes), pay.data_ptr(),
        bits.data_ptr(), n_rows, cap_words, block_rows, tile_rows, smem,
        _stream(rows),
    )
    _launched(gap_row_pack, rc)
    return pay, bits


# ----------------------------------------------------------------------
# B4c: segment metadata
# ----------------------------------------------------------------------
def gap_row_meta_plain(rows, enc, s_local, *, rows_per_block, n_segs,
                       seg_bits, n_bytes=None):
    dev = rows.device
    n_rows = rows.shape[0]
    g_n = n_rows // rows_per_block
    a = s_local[:, None] + row_starts(rows, enc)
    seg = a >> (seg_bits.bit_length() - 1)
    g = torch.arange(n_rows, device=dev)[:, None] // rows_per_block
    ok = (seg >= 0) & (seg < n_segs) & _row_symbols(n_rows, n_bytes, dev)
    idx = torch.where(ok, g * n_segs + seg, g_n * n_segs).reshape(-1)
    counts = torch.zeros(g_n * n_segs + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, idx, torch.ones_like(idx))
    firsts = torch.full((g_n * n_segs + 1,), _INT32_MAX, dtype=torch.int64,
                        device=dev)
    firsts.scatter_reduce_(0, idx, a.reshape(-1), "amin")
    return (counts[:-1].to(torch.int32).view(g_n, n_segs),
            firsts[:-1].to(torch.int32).view(g_n, n_segs))


def gap_row_meta(rows, enc, s_local, *, rows_per_block, n_segs, seg_bits,
                 max_len=16, n_bytes=None):
    """Per-segment metadata of G blocks of rows_per_block rows each.

    rows: (n_rows, 32) int32 input words, as `gap_row_pack` takes them;
    enc: its (256,) int32 ``(len << 20) | code`` table; s_local: (n_rows,)
    int64 block-local start bit of each row, the per-block exclusive cumsum
    of the rows' bits.  Every one of a row's 128 symbols is a codeword
    start, at its row-local start (`row_starts`) plus s_local; starts
    outside [0, n_segs) segments are dropped.  Returns (counts, firsts),
    each (G, n_segs) int32: the codewords starting in each segment and the
    first start bit (block-local), INT32_MAX where none starts; the kernel
    gives the plain version's result for such an s_local, and stays inside
    its buffers for any other.  max_len (at least the table's longest
    code, at most 16) sizes the kernel's window of segments (`meta_tile`)
    only.  n_bytes: None, or a (G,) int32 byte count per block, as
    `gap_row_pack` takes it: a byte at or past it is no start (s_local
    then comes from the bits `gap_row_pack` gave with the same counts)."""
    _check("rows", rows, torch.int32)
    n_rows = rows.shape[0]
    if rows.dim() != 2 or rows.shape[1] != ROW_WORDS or rows_per_block <= 0 \
            or n_rows % rows_per_block:
        raise ValueError(f"rows must be (G * {rows_per_block}, {ROW_WORDS}), "
                         f"got {tuple(rows.shape)}")
    if seg_bits <= 0 or seg_bits & (seg_bits - 1):
        raise ValueError("seg_bits must be a power of two")
    if not 1 <= max_len <= 16:
        raise ValueError(f"max_len must be in [1, 16], got {max_len}")
    _check("enc", enc, torch.int32, (256,))
    _check("s_local", s_local, torch.int64, (n_rows,))
    _same_device(rows, enc, s_local)
    _check_n_bytes(n_bytes, n_rows, rows_per_block, rows)
    kw = dict(rows_per_block=rows_per_block, n_segs=n_segs, seg_bits=seg_bits,
              n_bytes=n_bytes)
    if not _use_kernel(rows):
        return gap_row_meta_plain(rows, enc, s_local, **kw)
    if rows.data_ptr() % 16:
        # the kernel reads each row with 16-byte loads
        raise ValueError("rows must be 16-byte aligned")
    g_n = n_rows // rows_per_block
    counts = torch.zeros((g_n, n_segs), dtype=torch.int32, device=rows.device)
    firsts = torch.full((g_n, n_segs), _INT32_MAX, dtype=torch.int32,
                        device=rows.device)
    if n_rows == 0:
        return counts, firsts
    tile_rows, window, smem = meta_tile(seg_bits, max_len)
    rc = _lib("gap_encode").gap_row_meta_launch(
        rows.data_ptr(), enc.data_ptr(), s_local.data_ptr(), _ptr(n_bytes),
        counts.data_ptr(), firsts.data_ptr(), n_rows, rows_per_block, n_segs,
        seg_bits.bit_length() - 1, max_len, tile_rows, window, smem,
        _stream(rows),
    )
    _launched(gap_row_meta, rc)
    return counts, firsts


# ----------------------------------------------------------------------
# B4d: bit placement
# ----------------------------------------------------------------------
def gap_place_bits_plain(pay, bits, s_local, *, rows_per_block, out_words):
    dev = pay.device
    n_rows, cap_words = pay.shape
    g_n = n_rows // rows_per_block
    zero = torch.zeros((n_rows, 1), dtype=torch.int64, device=dev)
    bits = bits.to(torch.int64).clamp(0, 32 * cap_words)[:, None]
    k = torch.arange(cap_words + 1, device=dev)[None, :]
    keep = (bits - 32 * k).clamp(0, 32)  # bits of word k inside the row
    cur = torch.cat([_u32(pay), zero], 1)
    cur = cur & (((1 << keep) - 1) << (32 - keep))
    prev = torch.cat([zero, cur[:, :-1]], 1)
    sh = (s_local & 31)[:, None]
    v = (cur >> sh) | (_low_bits(prev, sh) << (32 - sh))
    dst = (s_local >> 5)[:, None] + k
    ok = (bits > 0) & (k <= (sh + bits - 1) >> 5) & (dst >= 0) & (dst < out_words)
    g = torch.arange(n_rows, device=dev)[:, None] // rows_per_block
    idx = torch.where(ok, g * out_words + dst, g_n * out_words)
    # the rows' bit ranges are disjoint, so the sum is the OR
    out = torch.zeros(g_n * out_words + 1, dtype=torch.int64, device=dev)
    out.index_add_(0, idx.reshape(-1), v.reshape(-1))
    return _to_i32(out[:-1]).view(g_n, out_words)


def gap_place_bits(pay, bits, s_local, *, rows_per_block, out_words):
    """Place G blocks' rows: returns (G, out_words) int32 MSB-first u32
    words, row r's first bits(r) bits at block-local bit s_local[r], zero
    elsewhere.  pay: (n_rows, cap_words) int32; bits: (n_rows,) int32;
    s_local: (n_rows,) int64.  Words past out_words are dropped."""
    _check("pay", pay, torch.int32)
    n_rows = pay.shape[0]
    if pay.dim() != 2 or rows_per_block <= 0 or n_rows % rows_per_block:
        raise ValueError(f"pay must be (G * {rows_per_block}, cap_words), "
                         f"got {tuple(pay.shape)}")
    _check("bits", bits, torch.int32, (n_rows,))
    _check("s_local", s_local, torch.int64, (n_rows,))
    _same_device(pay, bits, s_local)
    kw = dict(rows_per_block=rows_per_block, out_words=out_words)
    if not _use_kernel(pay):
        return gap_place_bits_plain(pay, bits, s_local, **kw)
    g_n = n_rows // rows_per_block
    # zeroed: the boundary words are OR'ed in, words past the bits stay 0
    out = torch.zeros((g_n, out_words), dtype=torch.int32, device=pay.device)
    if n_rows == 0:
        return out
    if pay.shape[1] % 4 == 0 and pay.data_ptr() % 16:
        # the kernel reads rows of whole 16-byte quads with 16-byte loads
        raise ValueError("pay must be 16-byte aligned")
    rc = _lib("gap_encode").gap_place_bits_launch(
        pay.data_ptr(), bits.data_ptr(), s_local.data_ptr(), out.data_ptr(),
        n_rows, rows_per_block, pay.shape[1], out_words, _stream(pay),
    )
    _launched(gap_place_bits, rc)
    return out


# ----------------------------------------------------------------------
# Orchestration
# ----------------------------------------------------------------------
def encode_blocks(blocks, enc, *, seg_bits, max_words, n_segs, max_len,
                  n_bytes=None):
    """Encode (G, B) uint8 blocks, any B >= 1.

    Bit-identical to `ops.encode.encode_block` per block: returns (words
    (G, max_words+1) int32 u32 bits, total_bits (G,) int32, gaps and
    counts (G, n_segs) int32).  enc: (256,) int32 ``(len << 20) | code``;
    max_len (at most 16) bounds the table's code lengths.  Words past
    max_words + 1 are dropped, and codeword starts past n_segs segments
    are counted in the last one, as `encode_block` does.  (The JAX
    function's min_len argument sized its VMEM windows only; its gaps
    differ from encode_block's where seg_bits is below the longest code,
    ROADMAP F13.)

    n_bytes: None (each block's B bytes), or a (G,) int32 count per block,
    each at most B: block g is its first n_bytes[g] bytes.  The rows are
    the blocks zero-padded to a multiple of 128 bytes, B4b and B4c take
    the counts where B is no such multiple or n_bytes is given."""
    g_n, b = blocks.shape
    if b == 0:
        raise ValueError("blocks must hold at least one byte")
    rows_b = -(-b // ROW_BYTES)
    pad = rows_b * ROW_BYTES - b
    if pad:
        if n_bytes is None:
            n_bytes = torch.full((g_n,), b, dtype=torch.int32,
                                 device=blocks.device)
        # a fresh copy: aligned for the int32 view and the 16-byte loads
        blocks = F.pad(blocks, (0, pad))
    elif not blocks.is_contiguous() or blocks.data_ptr() % 16:
        # a slice at any byte offset (a tail, a user's view): a copy is
        # aligned for the int32 view and the kernel's 16-byte row loads
        blocks = blocks.clone(memory_format=torch.contiguous_format)
    rows = blocks.view(torch.int32).view(g_n * rows_b, ROW_WORDS)
    pay, bits = gap_row_pack(rows, enc, cap_words=row_cap_words(max_len),
                             n_bytes=n_bytes)

    # XLA glue of the JAX package: per-block cumsum of the row bits
    bits_blk = bits.view(g_n, rows_b).to(torch.int64)
    ends = torch.cumsum(bits_blk, 1)
    total_bits = ends[:, -1:]
    s_local = (ends - bits_blk).reshape(-1)

    counts, firsts = gap_row_meta(rows, enc, s_local, rows_per_block=rows_b,
                                  n_segs=n_segs, seg_bits=seg_bits,
                                  max_len=max_len, n_bytes=n_bytes)
    if n_segs:
        # the starts past the last segment, which B4c drops, counted in it
        n_sym = b if n_bytes is None else n_bytes.to(torch.int64)
        counts[:, -1] += (n_sym - counts.sum(1, dtype=torch.int64)).to(
            torch.int32)
    if seg_bits < max_len:
        # a segment inside one codeword has no start: its gap points at the
        # next start, as encode_block's searchsorted does (from seg_bits =
        # max_len on, only segments past the last start lack one)
        firsts = torch.flip(torch.cummin(torch.flip(firsts, [1]), 1).values,
                            [1])
    bounds = torch.arange(n_segs, dtype=torch.int64,
                          device=blocks.device)[None] * seg_bits
    # a start-less segment below total_bits (the last codeword straddles
    # into it) points its gap at total_bits, as encode_block's searchsorted
    gaps = torch.where(bounds < total_bits,
                       torch.minimum(firsts, total_bits) - bounds, 0)
    words = gap_place_bits(pay, bits, s_local, rows_per_block=rows_b,
                           out_words=max_words + 1)
    return (words, total_bits[:, 0].to(torch.int32), gaps.to(torch.int32),
            counts)


_WRAPPERS = (gap_row_pack, gap_row_meta, gap_place_bits)
_NAMES = tuple(fn.__name__ for fn in _WRAPPERS)


def reset_launch_counts() -> None:
    trace.reset_launches(_NAMES)


def launch_counts() -> dict[str, int]:
    return trace.launches(_NAMES)
