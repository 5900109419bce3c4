"""Self-synchronising decoder: raw Huffman streams with no metadata.

Counterpart of `huffman_tpu/models/selfsync.py`.  Given only a canonical
code table and the packed MSB-first bit stream (no gap array, no counts,
e.g. the payload of a `sequential.cpp` blob), it finds every codeword
boundary and decodes data-parallel:

1. Transitions (kernel C2, `ops/selfsync_kernels.py`): every 1024-bit
   subsequence decoded from all 16 entry offsets, lengths only.
2. Composition scan (`_compose_scan`, plain PyTorch): each subsequence is
   a [16] -> [16] function of its entry state; pointer doubling composes
   the prefixes in log2(n) rounds of `torch.gather`, giving every
   subsequence's true entry state.  Counts are not carried through it:
   they are gathered afterwards and summed in int64.
3. Decode: the entries and counts act as a gap array would, through
   B1 + B2 (`ops/gap_decode_kernels.py`) at seg_bits=1024.

The JAX package pads the subsequence count to a power of two, plans VMEM
windows and falls back to a host mask compaction for sub-2-bit codes, all
for the TPU compiler and VMEM; none of it changes a byte, and none of it
is carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.canonical import CodeTable
from ..ops.gap_decode_kernels import decode_blocks, kernel_tabs
from ..ops.launch import resolve_device
from ..ops.selfsync_kernels import SYNC_STATES, sync_transitions
from ..ops.tables import dec_spec, device_dec_table

__all__ = [
    "selfsync_decode_words",
    "selfsync_decode_device",
    "selfsync_decode_bytes",
    "is_canonical",
]

_SEG_BITS = 1024


def _cdiv(a, b):
    return -(-a // b)


def _compose_scan(exits: torch.Tensor) -> torch.Tensor:
    """True entry state of every subsequence: (n,) int64.

    exits: (n, 16) int, exits[i, s] the exit state of subsequence i from
    entry state s.  Pointer doubling: after the round of distance d,
    ``p[i]`` is the composition of subsequences max(0, i-2d+1) .. i
    (``p[i][s] = p[i][p[i-d][s]]``); after log2(n) rounds ``p[i]`` maps
    the stream's entry state 0 to subsequence i's exit, which is
    subsequence i+1's entry."""
    p = exits.to(torch.int64)
    n = p.shape[0]
    d = 1
    while d < n:
        p = torch.cat([p[:d], torch.gather(p[d:], 1, p[:-d])])
        d *= 2
    return torch.cat([p.new_zeros(1), p[: n - 1, 0]])


def selfsync_decode_device(words: torch.Tensor, total_bits: int,
                           table: CodeTable) -> torch.Tensor:
    """Decode a raw stream that already lies on the device: words (W,)
    int32 MSB-first u32 payload (words past W read as zeros).  Returns
    the bytes as a uint8 tensor on the words' device.

    C2 -> scan -> per-subsequence counts -> one host sync of (total, max
    count) -> B1 + B2."""
    dev = words.device
    if total_bits == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    max_len = max(table.max_len_present, 1)
    if max_len > SYNC_STATES:
        raise ValueError("self-sync decode requires max codeword length <= 16")
    dec = device_dec_table(table, two_level=False, device=dev)
    spec = dec_spec(table)
    lim, _ = kernel_tabs(dec)
    n_subseq = _cdiv(total_bits, _SEG_BITS)
    packed = sync_transitions(words, lim, total_bits=total_bits,
                              seg_bits=_SEG_BITS, n_subseq=n_subseq,
                              min_len=spec.min_len, max_len=spec.max_len)
    entry = _compose_scan(packed.T >> 16)
    counts = torch.gather(packed & 0xFFFF, 0, entry[None, :])[0]
    total, top = torch.stack([counts.sum(dtype=torch.int64),
                              counts.max().long()]).tolist()
    return decode_blocks(
        words.view(1, -1), entry.to(torch.int32).view(1, -1),
        counts.view(1, -1), dec, spec=spec, seg_bits=_SEG_BITS,
        max_count=_cdiv(max(top, 1), 8) * 8, out_size=total,
    ).view(-1)


def selfsync_decode_words(words, total_bits: int, table: CodeTable, *,
                          device="cuda") -> torch.Tensor:
    """Decode a raw MSB-first u32 stream (a uint32 array, or an int32
    tensor of its bits) given only its canonical table, on `device` (CUDA
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(
            np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))
    return selfsync_decode_device(words.to(dev).contiguous(), total_bits, table)


def is_canonical(lengths: np.ndarray, codes: np.ndarray) -> bool:
    """True iff (codes, lengths) is a canonical code: codes of each length
    are consecutive and each level continues (prev + 1) << diff."""
    syms = np.nonzero(np.asarray(lengths) > 0)[0]
    if syms.size == 0:
        return True
    ls = np.asarray(lengths)[syms].astype(np.int64)
    cs = np.asarray(codes)[syms].astype(np.int64)
    order = np.lexsort((cs, ls))
    ls, cs = ls[order], cs[order]
    code = 0
    for i in range(syms.size):
        if i:
            code = (code + 1) << (ls[i] - ls[i - 1])
        if cs[i] != code:
            return False
    return True


def selfsync_decode_bytes(payload: np.ndarray, total_bits: int, code, *,
                          device="cuda") -> torch.Tensor:
    """Decode an MSB-first byte stream through self-sync (canonical codes
    up to 16 bits), else through the host LUT walk; returns a uint8
    tensor on `device`."""
    from ..io.seqfmt import PrefixCode, host_lut_decode
    from ..io.yamamoto import table_from_length_sequence

    dev = resolve_device(device)
    if not isinstance(code, PrefixCode):
        raise TypeError(f"a PrefixCode is expected, got {type(code).__name__}")
    if not is_canonical(code.lengths, code.codes) or code.max_len > SYNC_STATES:
        # foreign greedy-tree codes, or codes past the 16 entry states
        return torch.from_numpy(host_lut_decode(payload, total_bits, code)).to(dev)

    # canonical: rebuild the CodeTable in canonical (len, code) order
    syms = np.nonzero(code.lengths > 0)[0]
    ls = code.lengths[syms].astype(np.int64)
    cs = code.codes[syms].astype(np.int64)
    order = np.lexsort((cs, ls))
    table = table_from_length_sequence(syms[order].astype(np.uint8), ls[order])
    n_bytes = _cdiv(total_bits, 8)
    padded = np.zeros(_cdiv(n_bytes, 4) * 4 + 8, np.uint8)
    padded[:n_bytes] = payload[:n_bytes]
    words = padded.view(">u4").astype(np.uint32)
    return selfsync_decode_words(words, total_bits, table, device=dev)
