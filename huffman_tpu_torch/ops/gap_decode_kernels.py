"""HTC1 decode kernels B1 and B2: wrappers, plain versions, launch counts.

Counterpart of `huffman_tpu/ops/pallas/decode_kernel.py`
(`decode_ranks_pallas`, `decode_blocks_pallas`),
`huffman_tpu/ops/pallas/compact_kernel.py` (`ragged_concat_pallas`,
`rows_assemble_pallas`) and `huffman_tpu/ops/compact.py`.  The routing is
that of `ops/ils_kernels.py`: a CUDA tensor launches the kernel of
``csrc/gap_decode.cu`` or raises, a CPU tensor runs the plain version.

- `gap_decode_ranks` (B1, with B3's decode use folded in): one segment per
  thread, its ranks written as bytes into its own row of a
  ``(segments, max_count)`` matrix, zero past its count.
- `gap_place_bytes` (B2): ``out[off[s] + i] = symtab[rank[s, i]]`` for
  ``i < count[s]``, ``off`` the exclusive prefix sum of the counts.
- `decode_blocks`: both, for G equal-size blocks in one launch each.

The TPU's placement plans (`plan_compact`, `plan_tiles`, `_geometry`),
its 2-wide segment merge and its row budget (`MAX_ROW_BYTES`) size VMEM
windows; the exclusive prefix sum makes them unnecessary here, so every
table, including a one-symbol one, decodes through these two kernels.
"""

from __future__ import annotations

import torch

from .ils_kernels import (
    _check,
    _launched,
    _lib,
    _same_device,
    _stream,
    _to_i32,
    _u32,
    _use_kernel,
)
from .tables import DecSpec, DeviceDecTable

__all__ = [
    "kernel_tabs",
    "gap_decode_ranks",
    "gap_decode_ranks_plain",
    "gap_place_bytes",
    "gap_place_bytes_plain",
    "decode_blocks",
    "reset_launch_counts",
    "launch_counts",
]


def kernel_tabs(dec: DeviceDecTable):
    """(lim, bias), each (32,) int32: the u32 decode limits as int32 bits
    and the per-length rank bias offsets[l] - first_code[l]."""
    n = dec.lim_left.shape[0]
    lim = torch.zeros(32, dtype=torch.int64, device=dec.lim_left.device)
    bias = torch.zeros_like(lim)
    lim[:n] = dec.lim_left
    bias[:n] = dec.offsets.to(torch.int64) - dec.first_code
    return _to_i32(lim), bias.to(torch.int32)


# ----------------------------------------------------------------------
# B1: segment ranks
# ----------------------------------------------------------------------
def gap_decode_ranks_plain(words, gaps, counts, lim, bias, *, seg_bits,
                           max_count, min_len, max_len):
    dev = words.device
    g_n, n_words = words.shape
    n_segs = gaps.shape[1]
    flat = torch.cat([_u32(words).reshape(-1),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    base = torch.arange(g_n, device=dev)[:, None] * n_words
    lim = _u32(lim)
    bias = bias.to(torch.int64)

    def word(i):  # zero outside the block (the spare last entry of flat)
        ok = (i >= 0) & (i < n_words)
        return flat[torch.where(ok, base + i, flat.shape[0] - 1)]

    pos = (torch.arange(n_segs, device=dev)[None, :] * seg_bits
           + gaps.to(torch.int64))
    n = counts.to(torch.int64).clamp(0, max_count)
    ranks = torch.zeros((g_n, n_segs, max_count), dtype=torch.uint8, device=dev)
    for i in range(max_count):
        sh = pos & 31
        w0 = pos >> 5
        win = ((word(w0) << sh) & 0xFFFFFFFF) | (word(w0 + 1) >> (32 - sh))
        ln = torch.full_like(pos, min_len)
        for lv in range(min_len, max_len):
            ln += win >= lim[lv]
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
    _check("words", words, torch.int32)
    if words.dim() != 2 or gaps.dim() != 2 or gaps.shape[0] != words.shape[0]:
        raise ValueError(f"words (G, W) and gaps/counts (G, n_segs) expected; "
                         f"got {tuple(words.shape)} and {tuple(gaps.shape)}")
    _check("gaps", gaps, torch.int32)
    _check("counts", counts, torch.int32, gaps.shape)
    _check("lim", lim, torch.int32, (32,))
    _check("bias", bias, torch.int32, (32,))
    _same_device(words, gaps, counts, lim, bias)
    if not 1 <= min_len <= max_len <= 16 or seg_bits <= 0 or max_count < 0:
        raise ValueError(f"invalid decode shape: seg_bits={seg_bits}, "
                         f"max_count={max_count}, lengths {min_len}..{max_len}")
    kw = dict(seg_bits=seg_bits, max_count=max_count, min_len=min_len,
              max_len=max_len)
    if not _use_kernel(words):
        return gap_decode_ranks_plain(words, gaps, counts, lim, bias, **kw)
    g_n, n_segs = gaps.shape
    ranks = torch.empty((g_n * n_segs, max_count), dtype=torch.uint8,
                        device=words.device)
    if ranks.numel() == 0:
        return ranks
    rc = _lib("gap_decode").gap_decode_ranks_launch(
        words.data_ptr(), gaps.data_ptr(), counts.data_ptr(), lim.data_ptr(),
        bias.data_ptr(), ranks.data_ptr(), g_n * n_segs, n_segs,
        words.shape[1], seg_bits, max_count, min_len, max_len,
        _stream(words),
    )
    _launched(gap_decode_ranks, rc)
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
    _check("ranks", ranks, torch.uint8)
    if ranks.dim() != 2:
        raise ValueError(f"ranks must be (S, max_count), got {tuple(ranks.shape)}")
    n_segs = ranks.shape[0]
    _check("counts", counts, torch.int32, (n_segs,))
    _check("offsets", offsets, torch.int64, (n_segs,))
    _check("symtab", symtab, torch.int32, (256,))
    _same_device(ranks, counts, offsets, symtab)
    if not _use_kernel(ranks):
        return gap_place_bytes_plain(ranks, counts, offsets, symtab, n_out=n_out)
    out = torch.zeros(n_out, dtype=torch.uint8, device=ranks.device)
    if n_segs == 0 or n_out == 0:
        return out
    rc = _lib("gap_decode").gap_place_bytes_launch(
        ranks.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
        symtab.data_ptr(), out.data_ptr(), n_segs, ranks.shape[1], n_out,
        _stream(ranks),
    )
    _launched(gap_place_bytes, rc)
    return out


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


_WRAPPERS = (gap_decode_ranks, gap_place_bytes)
for _fn in _WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
