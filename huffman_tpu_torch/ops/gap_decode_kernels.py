"""Gap-array decode kernels B1, B2 and C1: wrappers, plain versions,
launch counts.

Counterpart of `huffman_tpu/ops/pallas/decode_kernel.py`
(`decode_ranks_pallas`, `decode_blocks_pallas`, `count_segments_pallas`),
`huffman_tpu/ops/pallas/compact_kernel.py` (`ragged_concat_pallas`,
`rows_assemble_pallas`) and `huffman_tpu/ops/compact.py`.  The routing is
that of `ops/launch.py`: a CUDA tensor launches the kernel of
``csrc/gap_decode.cu`` or raises, a CPU tensor runs the plain version.

- `gap_decode_ranks` (B1, with B3's decode use folded in): one segment per
  thread, its ranks written as bytes into its own row of a
  ``(segments, max_count)`` matrix, zero past its count; a CUDA block
  stages its R segments' payload words in shared memory, walks them from
  there and stores its R rows through a shared-memory tile, C columns at
  a time (`ranks_tile`).
- `gap_place_bytes` (B2): ``out[off[s] + i] = symtab[rank[s, i]]`` for
  ``i < count[s]``, ``off`` the exclusive prefix sum of the counts; a CUDA
  block places a run of `place_tile`'s R segments through a shared-memory
  buffer with 16-byte loads and stores.
- `decode_blocks`: both, for G equal-size blocks in one launch each.
- `count_segments` (C1): the symbols of each segment of a gap-only
  (Yamamoto) stream, the codewords that start before the next segment's
  entry; a CUDA thread advances several codewords a lookup in a count
  table on `COUNT_TAB_BITS` window bits, which a first kernel of the call
  builds.

The TPU's placement plans (`plan_compact`, `plan_tiles`, `_geometry`),
its 2-wide segment merge and its row budget (`MAX_ROW_BYTES`) size VMEM
windows; the exclusive prefix sum makes them unnecessary here, so every
table, including a one-symbol one, decodes through these two kernels.
"""

from __future__ import annotations

import torch

from .launch import (
    check,
    counters,
    launch,
    same_device,
    to_i32,
    u32,
    use_kernel,
)
from .tables import DecSpec, DeviceDecTable

__all__ = [
    "kernel_tabs",
    "ranks_tile",
    "stage_words",
    "place_tile",
    "gap_decode_ranks",
    "gap_decode_ranks_plain",
    "gap_place_bytes",
    "gap_place_bytes_plain",
    "decode_blocks",
    "count_segments",
    "count_segments_plain",
    "count_max",
    "walk_counts",
    "reset_launch_counts",
    "launch_counts",
]


RANK_ROWS = 128  # segments of a B1 block
RANK_CHUNK = 64  # widest column chunk of B1's tile
RANK_MAX_SMEM = 49152  # most dynamic shared memory of a B1 block
# An H100 SM: shared memory and threads it holds; the runtime keeps 1 KB a
# block, and B1's lim and bias take 256 B of static shared memory
SM_SMEM, SM_THREADS, BLOCK_EXTRA_SMEM = 233472, 2048, 1280
# B1 stages its payload only where an SM still holds this many of its
# threads: with fewer its walk's latency shows (on an H100 at the HTC1
# cell's shape, 6, 5 and 4 blocks of 128 an SM took 1.10x, 1.20x and 1.40x
# the time of 8; 9 to 18 no less than 8).  The staged words cost the same
# shared memory a thread whatever the rows a block, so fewer rows would not
# hold more threads.
SM_MIN_THREADS = 1024


def stage_words(seg_bits: int) -> int:
    """Words of a row of B1's staged tile: every word that a valid
    segment's walk reads, from the word of its first bit.  Its last
    codeword starts in word (phase + seg_bits - 1) // 32, the phase below
    32 (0 where seg_bits % 32 == 0); the window holds that word and the
    next, has loaded a third, and the last skip may load a fourth."""
    return (seg_bits - 1 + (31 if seg_bits % 32 else 0)) // 32 + 4


def ranks_tile(max_count: int, seg_bits: int) -> tuple[int, int, int, int]:
    """(rows per block R, column chunk C, staged pitch P, dynamic
    shared-memory bytes) of B1.  Each row stages P words of its segment's
    payload (`stage_words` rounded up to odd, so that a warp at one offset
    of its rows reads 32 banks), and the ranks go out through a tile of R
    rows of C + 4 bytes, C a multiple of 8 (odd in words) no wider than the
    row needs.  Where the staged rows would leave an SM fewer than
    SM_MIN_THREADS threads (seg_bits above 1024), P is 0: no word is staged
    and the walk reads device memory.  ``csrc/gap_decode.cu`` checks the
    same arithmetic."""
    chunk = min(RANK_CHUNK, -(-max(max_count, 1) // 8) * 8)
    pitch = stage_words(seg_bits) | 1
    smem = RANK_ROWS * (chunk + 4 + 4 * pitch)
    threads = RANK_ROWS * min(SM_THREADS // RANK_ROWS,
                              SM_SMEM // (smem + BLOCK_EXTRA_SMEM))
    if smem > RANK_MAX_SMEM or threads < SM_MIN_THREADS:
        pitch, smem = 0, RANK_ROWS * (chunk + 4)
    return RANK_ROWS, chunk, pitch, smem


PLACE_ROWS = 1024  # most segments of a B2 block (4 a thread for the scan)
PLACE_TILE = 32768  # bytes of rank rows a B2 block loads at once


def place_tile(max_count: int) -> tuple[int, int, int]:
    """(rows per block R, column chunk, dynamic shared-memory bytes) of B2:
    R = PLACE_TILE // max_count whole rows (at most PLACE_ROWS), or one row
    in chunks of PLACE_TILE columns where a row is wider than the tile.
    Shared memory holds a run's compacted bytes at the output's phase mod
    16 (R * chunk bytes, rounded up to 16, and 16 more) and two ints a row
    and two more.  ``csrc/gap_decode.cu`` checks the same arithmetic."""
    mc = max(max_count, 1)
    if mc <= PLACE_TILE:
        rows, chunk = min(PLACE_ROWS, PLACE_TILE // mc), mc
    else:
        rows, chunk = 1, PLACE_TILE
    return rows, chunk, 16 * (-(-rows * chunk // 16) + 1) + 8 * (rows + 1)


def kernel_tabs(dec: DeviceDecTable):
    """(lim, bias), each (32,) int32: the u32 decode limits as int32 bits
    and the per-length rank bias offsets[l] - first_code[l]."""
    n = dec.lim_left.shape[0]
    lim = torch.zeros(32, dtype=torch.int64, device=dec.lim_left.device)
    bias = torch.zeros_like(lim)
    lim[:n] = dec.lim_left
    bias[:n] = dec.offsets.to(torch.int64) - dec.first_code
    return to_i32(lim), bias.to(torch.int32)


# ----------------------------------------------------------------------
# The canonical bit walk (the plain counterpart of csrc/bitwalk.cuh)
# ----------------------------------------------------------------------
def _word_reader(words, n_words, base=0):
    """word(i): u32 word i of each stream, as int64; zero outside
    [0, n_words).  words: (..., n_words) int32, flattened row-major, each
    row starting at `base` (broadcast against i)."""
    flat = torch.cat([u32(words).reshape(-1),
                      torch.zeros(1, dtype=torch.int64, device=words.device)])

    def word(i):  # the spare last entry of flat reads as zero
        ok = (i >= 0) & (i < n_words)
        return flat[torch.where(ok, base + i, flat.shape[0] - 1)]

    return word


def _window(word, pos):
    """The 32 stream bits from bit `pos` (int64), MSB first."""
    sh = pos & 31
    w0 = pos >> 5
    return ((word(w0) << sh) & 0xFFFFFFFF) | (word(w0 + 1) >> (32 - sh))


def _code_len(win, lim, min_len, max_len):
    """Canonical length: min_len + #{l in [min_len, max_len): win >= lim[l]}
    (lim as u32 in int64)."""
    ln = torch.full_like(win, min_len)
    for lv in range(min_len, max_len):
        ln += win >= lim[lv]
    return ln


def walk_counts(words, pos, end, lim, *, min_len, max_len, max_count):
    """Codewords of a (W,) stream that start below `end`, walked from each
    `pos` (int64, any shape), at most max_count of them: returns (count,
    pos just past the last one counted), int64."""
    word = _word_reader(words, words.shape[0])
    lim = u32(lim)
    count = torch.zeros_like(pos)
    for _ in range(max_count):
        active = pos < end
        if not bool(active.any()):
            break
        ln = _code_len(_window(word, pos), lim, min_len, max_len)
        count += active
        pos = pos + torch.where(active, ln, 0)
    return count, pos


# ----------------------------------------------------------------------
# B1: segment ranks
# ----------------------------------------------------------------------
def gap_decode_ranks_plain(words, gaps, counts, lim, bias, *, seg_bits,
                           max_count, min_len, max_len):
    dev = words.device
    g_n, n_words = words.shape
    n_segs = gaps.shape[1]
    # zero outside each block
    word = _word_reader(words, n_words,
                        torch.arange(g_n, device=dev)[:, None] * n_words)
    lim = u32(lim)
    bias = bias.to(torch.int64)
    pos = (torch.arange(n_segs, device=dev)[None, :] * seg_bits
           + gaps.to(torch.int64))
    n = counts.to(torch.int64).clamp(0, max_count)
    ranks = torch.zeros((g_n, n_segs, max_count), dtype=torch.uint8, device=dev)
    for i in range(max_count):
        win = _window(word, pos)
        ln = _code_len(win, lim, min_len, max_len)
        rank = (bias[ln] + (win >> (32 - ln))) & 255
        active = i < n
        ranks[:, :, i] = torch.where(active, rank, 0).to(torch.uint8)
        pos = pos + torch.where(active, ln, 0)
    return ranks.view(g_n * n_segs, max_count)


def gap_decode_ranks(words, gaps, counts, lim, bias, *, seg_bits, max_count,
                     min_len, max_len):
    """Decode every segment of G blocks; returns (G * n_segs, max_count)
    uint8 canonical ranks (rank & 255), zero past each segment's count.

    words: (G, W) int32, each block's MSB-first u32 payload (words past W
    read as zeros); gaps, counts: (G, n_segs) int32; lim, bias: (32,)
    int32 (`kernel_tabs`).  Counts are clamped to [0, max_count]."""
    check("words", words, torch.int32)
    if words.dim() != 2 or gaps.dim() != 2 or gaps.shape[0] != words.shape[0]:
        raise ValueError(f"words (G, W) and gaps/counts (G, n_segs) expected; "
                         f"got {tuple(words.shape)} and {tuple(gaps.shape)}")
    check("gaps", gaps, torch.int32)
    check("counts", counts, torch.int32, gaps.shape)
    check("lim", lim, torch.int32, (32,))
    check("bias", bias, torch.int32, (32,))
    same_device(words, gaps, counts, lim, bias)
    if not 1 <= min_len <= max_len <= 16 or seg_bits <= 0 or max_count < 0:
        raise ValueError(f"invalid decode shape: seg_bits={seg_bits}, "
                         f"max_count={max_count}, lengths {min_len}..{max_len}")
    kw = dict(seg_bits=seg_bits, max_count=max_count, min_len=min_len,
              max_len=max_len)
    if not use_kernel(words):
        return gap_decode_ranks_plain(words, gaps, counts, lim, bias, **kw)
    g_n, n_segs = gaps.shape
    ranks = torch.empty((g_n * n_segs, max_count), dtype=torch.uint8,
                        device=words.device)
    if ranks.numel() == 0:
        return ranks
    tile_rows, chunk, pitch, smem = ranks_tile(max_count, seg_bits)
    launch("gap_decode", "gap_decode_ranks_launch",
           words.data_ptr(), gaps.data_ptr(), counts.data_ptr(), lim.data_ptr(),
           bias.data_ptr(), ranks.data_ptr(), g_n * n_segs, n_segs,
           words.shape[1], seg_bits, max_count, min_len, max_len, tile_rows,
           chunk, pitch, smem, like=words, counted=gap_decode_ranks)
    return ranks


# ----------------------------------------------------------------------
# B2: ragged placement
# ----------------------------------------------------------------------
def gap_place_bytes_plain(ranks, counts, offsets, symtab, *, n_out):
    dev = ranks.device
    max_count = ranks.shape[1]
    i = torch.arange(max_count, device=dev)[None, :]
    dst = offsets[:, None] + i
    ok = ((i < counts.to(torch.int64).clamp(0, max_count)[:, None])
          & (dst >= 0) & (dst < n_out))
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    out[dst[ok]] = symtab.to(torch.uint8)[ranks.to(torch.int64)][ok]
    return out


def gap_place_bytes(ranks, counts, offsets, symtab, *, n_out):
    """Place every segment's symbols: returns (n_out,) uint8 with
    ``out[offsets[s] + i] = symtab[ranks[s, i]]`` for i < counts[s].

    ranks: (S, max_count) uint8; counts: (S,) int32; offsets: (S,) int64
    exclusive prefix sum of the counts; symtab: (256,) int32.  Bytes no
    segment covers are zero; writes outside [0, n_out) are dropped."""
    check("ranks", ranks, torch.uint8)
    if ranks.dim() != 2:
        raise ValueError(f"ranks must be (S, max_count), got {tuple(ranks.shape)}")
    n_segs = ranks.shape[0]
    check("counts", counts, torch.int32, (n_segs,))
    check("offsets", offsets, torch.int64, (n_segs,))
    check("symtab", symtab, torch.int32, (256,))
    same_device(ranks, counts, offsets, symtab)
    if not use_kernel(ranks):
        return gap_place_bytes_plain(ranks, counts, offsets, symtab, n_out=n_out)
    out = torch.zeros(n_out, dtype=torch.uint8, device=ranks.device)
    max_count = ranks.shape[1]
    if n_segs == 0 or n_out == 0 or max_count == 0:
        return out
    rows, chunk, smem = place_tile(max_count)
    launch("gap_decode", "gap_place_bytes_launch",
           ranks.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
           symtab.data_ptr(), out.data_ptr(), n_segs, max_count, n_out, rows,
           chunk, smem, like=ranks, counted=gap_place_bytes)
    return out


# ----------------------------------------------------------------------
# C1: symbol counts of a gap-only stream
# ----------------------------------------------------------------------
# Window bits of C1's count table (``csrc/gap_decode.cu`` COUNT_TAB_BITS):
# 2 ** COUNT_TAB_BITS u16 entries, built into a buffer of the call
COUNT_TAB_BITS = 13


def count_max(seg_bits: int, min_len: int) -> int:
    """Most codewords C1 counts in a segment.  A valid stream's entry
    offsets are below 16 bits (max_len <= 16), so its segments never reach
    it; it keeps a corrupt gap from sending a thread far."""
    return (seg_bits + 16) // min_len + 1


def count_segments_plain(words, gaps, lim, *, seg_bits, total_bits, min_len,
                         max_len):
    pos = (torch.arange(gaps.shape[0], device=words.device) * seg_bits
           + gaps.to(torch.int64))
    end = torch.cat([pos[1:], pos.new_full((1,), total_bits)]).clamp(
        max=total_bits)
    count, _ = walk_counts(words, pos, end, lim, min_len=min_len,
                           max_len=max_len,
                           max_count=count_max(seg_bits, min_len))
    return count.to(torch.int32)


def count_segments(words, gaps, lim, *, seg_bits, total_bits, min_len,
                   max_len):
    """Symbols per segment of a gap-only stream: (S,) int32.

    Segment s enters at bit ``s * seg_bits + gaps[s]`` and counts the
    codewords that start before the next segment's entry (the last one:
    before `total_bits`), at most `count_max`.  words: (W,) int32
    MSB-first u32 payload (words past W read as zeros); gaps: (S,) int32;
    lim: (32,) int32 (`kernel_tabs`)."""
    check("words", words, torch.int32)
    check("gaps", gaps, torch.int32)
    if words.dim() != 1 or gaps.dim() != 1:
        raise ValueError(f"words (W,) and gaps (S,) expected; got "
                         f"{tuple(words.shape)} and {tuple(gaps.shape)}")
    check("lim", lim, torch.int32, (32,))
    same_device(words, gaps, lim)
    if not 1 <= min_len <= max_len <= 16 or seg_bits <= 0:
        raise ValueError(f"invalid count shape: seg_bits={seg_bits}, "
                         f"lengths {min_len}..{max_len}")
    kw = dict(seg_bits=seg_bits, total_bits=total_bits, min_len=min_len,
              max_len=max_len)
    if not use_kernel(words):
        return count_segments_plain(words, gaps, lim, **kw)
    n_segs = gaps.shape[0]
    counts = torch.empty(n_segs, dtype=torch.int32, device=words.device)
    if n_segs == 0:
        return counts
    tab = torch.empty(1 << COUNT_TAB_BITS, dtype=torch.int16,
                      device=words.device)
    # one count a call, though a call launches two kernels (the table's,
    # where the code has more than one length)
    launch("gap_decode", "gap_count_segments_launch",
           words.data_ptr(), gaps.data_ptr(), lim.data_ptr(), tab.data_ptr(),
           counts.data_ptr(), n_segs, words.shape[0], total_bits, seg_bits,
           count_max(seg_bits, min_len), min_len, max_len, like=words,
           counted=count_segments)
    return counts


# ----------------------------------------------------------------------
# Orchestration
# ----------------------------------------------------------------------
def decode_blocks(words, gaps, counts, dec: DeviceDecTable, *, spec: DecSpec,
                  seg_bits: int, max_count: int, out_size: int):
    """Decode G independent equal-size blocks: returns (G, out_size) uint8.

    words: (G, W) int32 payload per block; gaps, counts: (G, n_segs)
    int32, each row's counts summing to out_size; max_count >= every
    count.  The blocks' segments form one flat stream, so the exclusive
    prefix sum of all counts places block g at g * out_size."""
    g_n, n_segs = gaps.shape
    if out_size == 0 or n_segs == 0:
        return torch.zeros((g_n, out_size), dtype=torch.uint8,
                           device=words.device)
    lim, bias = kernel_tabs(dec)
    ranks = gap_decode_ranks(
        words, gaps, counts, lim, bias, seg_bits=seg_bits,
        max_count=max_count, min_len=spec.min_len, max_len=spec.max_len,
    )
    flat = counts.reshape(-1)
    offsets = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    out = gap_place_bytes(ranks, flat, offsets, dec.symtab,
                          n_out=g_n * out_size)
    return out.view(g_n, out_size)


reset_launch_counts, launch_counts = counters(
    gap_decode_ranks, gap_place_bytes, count_segments)
