"""HTC1 step decoders: every segment advances one codeword per step.

Counterpart of `huffman_tpu/ops/decode.py`, the JAX package's portable
decode (XLA code there, not a Pallas kernel, so plain tensor code here).
All segments of a block advance in lock-step over ``max_count`` steps,
each step decoding one codeword from every segment's 32-bit window by one
of three methods:

- "lut": one lookup in the flat 2^lut_bits table;
- "canonical": the code length from the canonical limits (one compare per
  level), the symbol from the rank;
- "twolevel": the reference's L1/L2 probe (short codes in the 2^p L1, a
  long code's prefix points at its L2 subtable).

`decode_block` places the symbols with the scatter, cumsum and gather of
the JAX package; `count_segments` is the counting pass of gap-only
(Yamamoto) streams.  The CUDA path of the codecs is B1 placing its bytes
(`ops/gap_decode_kernels.py`, whose C1 wrapper is also named
``count_segments``); callers import each by its module.
"""

from __future__ import annotations

import torch

from .bitops import extract_window32
from .tables import DecSpec, DeviceDecTable

__all__ = ["decode_block", "count_segments"]

_M32 = 0xFFFFFFFF


def _decode_step(window, dec: DeviceDecTable, spec: DecSpec, method: str):
    """One codeword from each 32-bit window (int64 u32 values): returns
    (symbol, length), int64.  Indices are clamped as the JAX package's
    gathers clamp them; only windows of inactive segments reach the
    clamps."""
    if method == "lut":
        idx = window >> (32 - spec.lut_bits)
        return dec.lut_sym[idx].long(), dec.lut_len[idx].long()
    if method == "canonical":
        # length = 1 + #{l in [1, max_len - 1] : window >= lim_left[l]}
        ln = torch.ones_like(window)
        for lv in range(1, spec.max_len):
            ln += window >= dec.lim_left[lv]
        rank = dec.offsets[ln] + (window >> (32 - ln)) - dec.first_code[ln]
        return dec.symtab[rank.clamp(0, 255)].long(), ln
    if method == "twolevel":
        p = spec.prefix_bits
        if p <= 0 or dec.l1_sym.shape[0] != (1 << p):
            raise ValueError(
                "decode table lacks the two-level form; build it with "
                "device_dec_table(table, two_level=True)"
            )
        idx1 = window >> (32 - p)
        is_long = idx1 >= spec.l1_boundary
        pidx = (idx1 - spec.l1_boundary).clamp(0, dec.ptr_tab.shape[0] - 1)
        ptr = dec.ptr_tab[pidx]
        width = ptr >> 16
        # a zero width (an unused prefix) keeps the guarded two-shift form
        sub = (window << p) & _M32
        v2 = (sub >> 1) >> (31 - width)
        idx2 = ((ptr & 0xFFFF) + v2).clamp(0, dec.l2_sym.shape[0] - 1)
        sym = torch.where(is_long, dec.l2_sym[idx2], dec.l1_sym[idx1])
        ln = torch.where(is_long, dec.l2_len[idx2], dec.l1_len[idx1])
        return sym.long(), ln.long()
    raise ValueError(f"unknown decode method: {method}")


def _u32_words(words: torch.Tensor) -> torch.Tensor:
    return words.reshape(-1).to(torch.int64) & _M32


def decode_block(words, gaps, counts, dec: DeviceDecTable, *, spec: DecSpec,
                 seg_bits: int, max_count: int, out_size: int,
                 method: str = "lut") -> torch.Tensor:
    """One-pass decode of a block from its per-segment (gap, count).

    words: (W,) int32, the MSB-first u32 payload's bits with at least one
    zero pad word; gaps, counts: (S,) int32, counts summing to out_size;
    max_count: at least every count (the number of steps).  Returns
    (out_size,) uint8 on the words' device."""
    dev = words.device
    w = _u32_words(words)
    s = gaps.shape[0]
    pos = torch.arange(s, device=dev) * seg_bits + gaps.to(torch.int64)
    rem = rem0 = counts.to(torch.int64)
    cols = torch.empty((max_count, s), dtype=torch.uint8, device=dev)
    for i in range(max_count):
        sym, ln = _decode_step(extract_window32(w, pos), dec, spec, method)
        active = rem > 0
        pos = pos + torch.where(active, ln, 0)
        rem = rem - active.long()
        cols[i] = torch.where(active, sym, 0).to(torch.uint8)
    if s == 0 or max_count == 0:
        return torch.zeros(out_size, dtype=torch.uint8, device=dev)
    # symbol k of the block is step (k - out_offs[seg]) of segment seg; the
    # segment ids come from a scatter of each segment's first output index
    # (the spare last slot takes those at out_size) and a cumsum
    out_offs = torch.cumsum(rem0, 0) - rem0
    marks = torch.zeros(out_size + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, out_offs.clamp(0, out_size), torch.ones_like(out_offs))
    seg_id = (torch.cumsum(marks[:out_size], 0) - 1).clamp(0, s - 1)
    t = torch.arange(out_size, device=dev) - out_offs[seg_id]
    return cols.view(-1)[t.clamp(0, max_count - 1) * s + seg_id]


def count_segments(words, gaps, total_bits: int, dec: DeviceDecTable, *,
                   spec: DecSpec, seg_bits: int, max_count: int,
                   method: str = "lut") -> torch.Tensor:
    """Codewords per segment of a gap-only stream: (S,) int32.

    Segment s decodes from its entry ``s * seg_bits + gaps[s]`` up to the
    next segment's entry (the last one: up to ``total_bits``), at most
    max_count codewords.  words: (W,) int32 with at least one zero pad
    word."""
    dev = words.device
    w = _u32_words(words)
    s = gaps.shape[0]
    pos = torch.arange(s, device=dev) * seg_bits + gaps.to(torch.int64)
    ends = torch.cat([pos[1:], pos.new_full((1,), total_bits)]).clamp(
        max=total_bits)
    cnt = torch.zeros(s, dtype=torch.int64, device=dev)
    # counting needs lengths only: "canonical" takes the grouped compare
    # chain from min_len, without the symbol lookup
    chain = spec.chain or tuple((lv, 1) for lv in range(spec.min_len, spec.max_len))
    for _ in range(max_count):
        window = extract_window32(w, pos)
        if method == "canonical":
            ln = torch.full_like(window, spec.min_len)
            for lv, wt in chain:
                ln += torch.where(window >= dec.lim_left[lv], wt, 0)
        else:
            _, ln = _decode_step(window, dec, spec, method)
        active = pos < ends
        pos = pos + torch.where(active, ln, 0)
        cnt += active
    return cnt.to(torch.int32)
