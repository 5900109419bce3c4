"""Data-parallel HTC1 encode of one block as PyTorch operations.

Counterpart of `huffman_tpu/ops/encode.py`, bit-identical to it.

- `encode_block`: gather the code lengths, one cumsum for the start bits,
  a scatter-add of each codeword's two u32 pieces (their bit ranges are
  disjoint, so the sum is the OR) and a ``searchsorted`` of the segment
  bounds for the (gap, count) metadata.  The port of the JAX package's
  public function and the tests' oracle: no codec path calls it, since
  `ops/gap_encode_kernels.py::encode_blocks` encodes blocks of any size
  (a ragged tail too) with the kernels B4b-B4d.
- `encode_block_fast`: the same outputs from the encode map kernel B5
  (`ops/encode_map_kernels.py`), which packs each 4-byte group into 64
  bits, so the placement and the metadata run once per group;
- `histogram`: the (256,) byte count of a tensor where it lies, by the
  byte histogram kernel (`ops/histogram_kernels.py`).

Around the kernels these are XLA functions in the JAX package, not kernels,
and run as plain tensor code on any device.
"""

from __future__ import annotations

import torch

from .encode_map_kernels import MAP_ALIGN, encode_map
from .histogram_kernels import byte_counts
from .launch import M32, to_i32, u32

__all__ = ["encode_block", "encode_block_fast", "histogram"]

_I32_MAX = (1 << 31) - 1


def histogram(data: torch.Tensor) -> torch.Tensor:
    """(256,) int32 byte histogram of a uint8 tensor, counted on its
    device by `byte_counts` (a scatter-add in the JAX package, XLA code
    there)."""
    return byte_counts(data).to(torch.int32)


def encode_block(data: torch.Tensor, enc: torch.Tensor, *, seg_bits: int,
                 max_words: int, n_segs: int):
    """Encode one (B,) uint8 block (B >= 1) into MSB-first u32 units with
    the (256,) int32 table of ``(len << 20) | code`` (`ils_enc_tabs`, the
    table the kernels read).

    Returns (words (max_words+1,) int32 — the u32 bits, zero past
    total_bits, with one zero pad unit —, total_bits () int32, gaps
    (n_segs,) int32, counts (n_segs,) int32): gap[k] is the offset of the
    first codeword starting at or after bit k*seg_bits (0 past the last
    segment), count[k] the codewords starting in segment k.  ``max_words``
    must be at least ceil(total_bits/32) and ``n_segs`` at least
    ceil(total_bits/seg_bits); units past max_words are dropped, as the JAX
    package's segment sums drop them."""
    dev = data.device
    idx = data.reshape(-1).to(torch.int64)
    e = enc.to(torch.int64)[idx]
    lens = e >> 20
    ends = torch.cumsum(lens, 0)
    total_bits = ends[-1]
    offs = ends - lens  # exclusive start bit per codeword

    # left-justified codes; an absent symbol (length 0) has code 0
    left = ((e & 0xFFFF) << (32 - lens)) & M32
    sh = offs & 31
    w0 = offs >> 5
    num_units = max_words + 1
    words = torch.zeros(num_units + 1, dtype=torch.int64, device=dev)
    # the spare last unit takes what the JAX segment sums drop
    words.index_add_(0, w0.clamp(max=num_units), left >> sh)
    words.index_add_(0, (w0 + 1).clamp(max=num_units),
                     (left << (32 - sh)) & M32)

    bounds = torch.arange(n_segs, dtype=torch.int64, device=dev) * seg_bits
    first = torch.searchsorted(offs, bounds)  # side="left"
    offs_pad = torch.cat([offs, total_bits[None]])
    gaps = torch.where(bounds < total_bits, offs_pad[first] - bounds, 0)
    first_next = torch.cat([first[1:], first.new_full((1,), idx.numel())])
    return (to_i32(words[:num_units]), total_bits.to(torch.int32),
            gaps.to(torch.int32), (first_next - first).to(torch.int32))


def encode_block_fast(data: torch.Tensor, enc_tabs: torch.Tensor, *,
                      seg_bits: int, max_words: int, n_segs: int):
    """`encode_block` through the encode map kernel, with its outputs bit
    for bit; ``data`` is (B,) uint8 with B a multiple of 4096, ``enc_tabs``
    the (256,) int32 ``(len << 20) | code`` table (the JAX function's
    parameter name; its value there is an `IlsEncTabs`).

    Each 4-byte group is one left-justified 64-bit item: an int64 cumsum of
    the group lengths places it, its three u32 pieces at words w0, w0+1
    and w0+2 are scatter-added (disjoint bit ranges), and the metadata
    comes from group-level reductions.  A group spans at most 64 bits, so
    its symbols start in at most two segments of a codec's seg_bits (128
    and up): counts by scatter-adds and each segment's first start by a
    scatter-min at the group's segment and the next.  Segment ids from
    n_segs on, and words past max_words, go to a spare last slot, as the
    JAX package's segment reductions drop them."""
    b = data.numel()
    if b % MAP_ALIGN or b == 0:
        raise ValueError(f"encode_block_fast needs a block of a positive "
                         f"multiple of {MAP_ALIGN} bytes, got {b}")
    shift = seg_bits.bit_length() - 1
    if seg_bits != 1 << shift:
        raise ValueError(f"seg_bits must be a power of two, got {seg_bits}")
    data = data.reshape(-1)
    if data.data_ptr() % 16:  # the kernel loads whole words
        data = data.clone()
    dev = data.device
    hi, lo, l4, lens_p = encode_map(data, enc_tabs)
    hi, lo, l4 = u32(hi), u32(lo), l4.to(torch.int64)
    ends4 = torch.cumsum(l4, 0)
    total_bits = ends4[-1]
    goffs = ends4 - l4
    sh = goffs & 31
    w0 = goffs >> 5
    low = (1 << sh) - 1  # the bits of a word that spill into the next
    pieces = (hi >> sh, ((hi & low) << (32 - sh)) | (lo >> sh),
              (lo & low) << (32 - sh))
    num_units = max_words + 1
    words = torch.zeros(num_units + 1, dtype=torch.int64, device=dev)
    for j, c in enumerate(pieces):
        words.index_add_(0, (w0 + j).clamp(max=num_units), c)

    l0 = (lens_p >> 15) & 31
    l1 = (lens_p >> 10) & 31
    l2 = (lens_p >> 5) & 31
    sid0 = goffs >> shift
    s1 = goffs + l0
    s2 = s1 + l1
    s3 = s2 + l2
    in0 = [(s >> shift) == sid0 for s in (s1, s2, s3)]
    m = 1 + in0[0].long() + in0[1].long() + in0[2].long()  # in the first seg
    here = sid0.clamp(max=n_segs)
    nxt = (sid0 + 1).clamp(max=n_segs)
    counts = torch.zeros(n_segs + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, here, m)
    counts.index_add_(0, nxt, 4 - m)
    # a segment's first start: a group's own start (monotone), or the first
    # symbol of the group before it that crosses into it
    big = torch.full_like(goffs, _I32_MAX)
    x = torch.where(~in0[0], s1, torch.where(~in0[1], s2,
                                             torch.where(~in0[2], s3, big)))
    first = torch.full((n_segs + 1,), _I32_MAX, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, here, goffs, "amin")
    first.scatter_reduce_(0, nxt, x, "amin")
    # a final segment without a start of its own keeps the identity; its
    # gap points at total_bits, as encode_block's searchsorted does
    bounds = torch.arange(n_segs, dtype=torch.int64, device=dev) * seg_bits
    gaps = torch.where(bounds < total_bits,
                       torch.minimum(first[:n_segs], total_bits) - bounds, 0)
    return (to_i32(words[:num_units]), total_bits.to(torch.int32),
            gaps.to(torch.int32), counts[:n_segs].to(torch.int32))
