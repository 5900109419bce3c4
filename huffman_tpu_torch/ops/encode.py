"""Data-parallel HTC1 encode of one block as PyTorch operations.

Counterpart of `huffman_tpu/ops/encode.py::encode_block`, bit-identical
to it: gather the code lengths, one cumsum for the start
bits, a scatter-add of each codeword's two u32 pieces (their bit ranges are
disjoint, so the sum is the OR) and a ``searchsorted`` of the segment
bounds for the (gap, count) metadata.  These are XLA functions in the JAX
package, not kernels, and run as plain tensor code on any device.  The
codec takes this route for blocks whose size is not a multiple of 128
bytes; `ops/gap_encode_kernels.py` encodes the others.
"""

from __future__ import annotations

import torch

from .ils_kernels import _M32, _to_i32

__all__ = ["encode_block"]


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
    left = ((e & 0xFFFF) << (32 - lens)) & _M32
    sh = offs & 31
    w0 = offs >> 5
    num_units = max_words + 1
    words = torch.zeros(num_units + 1, dtype=torch.int64, device=dev)
    # the spare last unit takes what the JAX segment sums drop
    words.index_add_(0, w0.clamp(max=num_units), left >> sh)
    words.index_add_(0, (w0 + 1).clamp(max=num_units),
                     (left << (32 - sh)) & _M32)

    bounds = torch.arange(n_segs, dtype=torch.int64, device=dev) * seg_bits
    first = torch.searchsorted(offs, bounds)  # side="left"
    offs_pad = torch.cat([offs, total_bits[None]])
    gaps = torch.where(bounds < total_bits, offs_pad[first] - bounds, 0)
    first_next = torch.cat([first[1:], first.new_full((1,), idx.numel())])
    return (_to_i32(words[:num_units]), total_bits.to(torch.int32),
            gaps.to(torch.int32), (first_next - first).to(torch.int32))
