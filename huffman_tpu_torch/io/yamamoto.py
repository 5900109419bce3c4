"""Yamamoto gap-array container interop (the ICPP'20 reference format).

Counterpart of `huffman_tpu/io/yamamoto.py`.  The reader and writer are
host NumPy and byte-exact with the JAX package's; the container is

    symbol_count   size_t (8 bytes LE)
    symbol_count x (symbol u8, length u8)   # increasing code length, codes
                                            # rebuilt canonically in this order
    inputfilesize  u32   (original bytes)
    outputfilesize u32   (payload u32 words)
    gap_elements   u32   (= ceil(payload_bits / 128))
    gap array      u32 x ceil(gap_elements / 8)   # 4-bit entries, 8 per u32;
                                                  # element j = entry bit
                                                  # offset of segment j+1
    payload        u32 x outputfilesize     # MSB-first bit stream

Decode runs on the device in two passes: the count kernel C1
(`ops/gap_decode_kernels.py::count_segments`) counts each 128-bit
segment's codewords against the word-count bound, one host sync reads the
sum and the last count, the last segment sheds the padding's surplus
(the JAX package's CPU check, ROADMAP trap F7), and B1 decodes and
places the bytes.  The JAX package's TPU path merges segments
8/4/2/1-wide and plans VMEM windows; none of that changes a byte, and
none of it is carried over.
``method="lut"`` or ``"canonical"`` runs the step decoders of
`ops/decode.py` for both passes instead; ``"twolevel"`` raises, as in the
JAX package, whose decode table here lacks the two-level form.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..constants import REF_SEG_BITS
from ..core import npref
from ..core.canonical import CodeTable
from ..ops import decode as step
from ..ops.gap_decode_kernels import count_segments, decode_blocks, kernel_tabs
from ..ops.launch import resolve_device
from ..ops.tables import DecSpec, DeviceDecTable, dec_spec, device_dec_table

__all__ = [
    "table_from_length_sequence",
    "write_yamamoto",
    "yamamoto_bytes",
    "read_yamamoto",
    "decode_yamamoto",
    "decode_yamamoto_device",
]

_SEGMENT_BITS = REF_SEG_BITS  # 128
_GAP_PER_WORD = 8  # 4-bit elements per u32


def table_from_length_sequence(symbols: np.ndarray, lens: np.ndarray) -> CodeTable:
    """Rebuild a CodeTable from a (symbol, length) sequence in canonical file
    order (length ascending, arbitrary tie order).

    The reference ties by its frequency-sort order, not by symbol, so the
    canonical recurrence runs over the sequence as given:
    code_i = (code_{i-1} + 1) << (len_i - len_{i-1}); `symtab` keeps the
    file's order."""
    symbols = np.asarray(symbols, np.uint8)
    lens = np.asarray(lens, np.int64)
    if np.any(np.diff(lens) < 0):
        raise ValueError("length sequence not ascending")
    n = symbols.size
    max_len = int(lens.max()) if n else 0
    lengths = np.zeros(256, np.uint8)
    codes = np.zeros(256, np.uint32)
    counts = np.zeros(max_len + 1, np.int32)
    first_code = np.zeros(max_len + 1, np.uint32)
    offsets = np.zeros(max_len + 1, np.int32)
    lim_left = np.zeros(max_len + 1, np.uint32)

    code = 0
    for i in range(n):
        l = int(lens[i])
        if i:
            code = (code + 1) << (l - int(lens[i - 1]))
        lengths[symbols[i]] = l
        codes[symbols[i]] = code
        counts[l] += 1
    if n:
        kraft = int(np.sum(1 << (max_len - lens)))
        if kraft > (1 << max_len):
            raise ValueError("length sequence violates Kraft inequality")
        offsets[1:] = np.cumsum(counts[:-1].astype(np.int64)).astype(np.int32)
        nc = 0
        for l in range(1, max_len + 1):
            first_code[l] = nc
            nc = (nc + int(counts[l])) << 1
        for l in range(1, max_len + 1):
            v = (int(first_code[l]) + int(counts[l])) << (32 - l)
            lim_left[l] = min(v, 0xFFFFFFFF)
    return CodeTable(
        lengths=lengths,
        codes=codes,
        max_len=max(max_len, 1),
        symtab=symbols.copy(),
        counts=counts,
        first_code=first_code,
        offsets=offsets,
        lim_left=lim_left,
    )


def yamamoto_bytes(table: CodeTable, words: np.ndarray, gaps: np.ndarray,
                   original_size: int) -> bytes:
    """The container of an encoded stream: its exact MSB-first payload words
    and the entry offset of each 128-bit segment (``gaps[0]`` is 0 and not
    stored)."""
    gaps = np.asarray(gaps)
    n_segs = gaps.shape[0]
    # element j = entry offset of segment j+1; the last element is unused
    elems = np.zeros(n_segs, np.uint32)
    if n_segs > 1:
        elems[: n_segs - 1] = gaps[1:].astype(np.uint32)
    gap_words = np.zeros(-(-n_segs // _GAP_PER_WORD), np.uint32)
    for j in range(_GAP_PER_WORD):
        part = elems[j::_GAP_PER_WORD]
        gap_words[: part.size] |= part << np.uint32(4 * j)

    syms = table.symtab
    entries = np.empty((len(syms), 2), np.uint8)
    entries[:, 0] = syms
    entries[:, 1] = table.lengths[syms]
    return b"".join(
        [
            struct.pack("<Q", len(syms)),
            entries.tobytes(),
            struct.pack("<III", original_size, words.size, n_segs),
            gap_words.tobytes(),
            np.asarray(words).astype("<u4").tobytes(),
        ]
    )


def write_yamamoto(data: np.ndarray, table: CodeTable) -> bytes:
    """Encode bytes into a reference-format container (host NumPy; the
    payload the reference encoder emits for the same code table)."""
    data = np.asarray(data, np.uint8)
    words, _ = npref.encode_bits(data, table)
    gaps, _, _ = npref.segment_metadata(data, table, _SEGMENT_BITS)
    # encode_bits appends one pad word; the format stores the exact payload
    return yamamoto_bytes(table, words[:-1], gaps, data.size)


def read_yamamoto(buf: bytes):
    """Parse a reference-format container.

    Returns (table, words (W,) uint32, gaps (n_segs,) uint8, original_size).
    """
    mv = memoryview(buf)
    if len(buf) < 8:
        raise ValueError("truncated Yamamoto container")
    (symbol_count,) = struct.unpack_from("<Q", mv, 0)
    off = 8
    if symbol_count > 256 or off + 2 * symbol_count + 12 > len(buf):
        raise ValueError("implausible Yamamoto header")
    entries = np.frombuffer(mv, np.uint8, 2 * symbol_count, off).reshape(-1, 2)
    off += 2 * symbol_count
    original_size, n_words, n_segs = struct.unpack_from("<III", mv, off)
    off += 12
    n_gap_words = -(-n_segs // _GAP_PER_WORD)
    if off + 4 * (n_gap_words + n_words) > len(buf):
        raise ValueError("truncated Yamamoto container")
    gap_words = np.frombuffer(mv, np.uint32, n_gap_words, off)
    off += 4 * n_gap_words
    words = np.frombuffer(mv, "<u4", n_words, off).astype(np.uint32)

    table = table_from_length_sequence(entries[:, 0], entries[:, 1].astype(np.int64))
    j = np.arange(n_segs, dtype=np.int64)
    elems = (gap_words[j // _GAP_PER_WORD] >> ((j % _GAP_PER_WORD) * 4)) & 0xF
    gaps = np.zeros(n_segs, np.uint8)
    gaps[1:] = elems[: n_segs - 1].astype(np.uint8)  # element j -> segment j+1
    return table, words, gaps, int(original_size)


def decode_yamamoto_device(words: torch.Tensor, gaps: torch.Tensor,
                           original_size: int, dec: DeviceDecTable,
                           spec: DecSpec) -> torch.Tensor:
    """Decode a parsed container that already lies on the device: words
    (W,) int32 payload, gaps (S,) int32 segment entry offsets.  Returns
    (original_size,) uint8 on the words' device.

    The format stores no exact bit count: C1 counts against the word-count
    bound, and the surplus (the padding's codewords, all in the last
    segment) comes off the last count.  One host sync reads the sum, the
    last count and the largest."""
    n_segs = gaps.shape[0]
    if original_size == 0:
        return torch.zeros(0, dtype=torch.uint8, device=words.device)
    lim, _ = kernel_tabs(dec)
    counts = count_segments(words, gaps, lim, seg_bits=_SEGMENT_BITS,
                            total_bits=words.shape[0] * 32,
                            min_len=spec.min_len, max_len=spec.max_len)
    total, last, top = (torch.stack([counts.sum(dtype=torch.int64),
                                     counts[-1].long(), counts.max().long()])
                        .tolist() if n_segs else (0, 0, 0))
    excess = total - original_size
    if excess < 0 or excess > last:
        raise ValueError("corrupt container: symbol count mismatch")
    counts[-1] -= excess
    # C1's counts are not negative, nor the last once its surplus is off
    return decode_blocks(
        words.view(1, -1), gaps.view(1, -1), counts.view(1, -1), dec,
        spec=spec, seg_bits=_SEGMENT_BITS, max_count=-(-max(top, 1) // 8) * 8,
        out_size=original_size, counts_in_range=True,
    ).view(-1)


def decode_yamamoto(buf: bytes, method: str | None = None, *,
                    device="cuda") -> torch.Tensor:
    """Decode a reference-format container on `device` (CUDA unless the
    caller asks for the CPU); returns the bytes as a uint8 tensor there.

    ``method``: None or "pallas" runs C1 + B1 (placing its bytes)
    (`decode_yamamoto_device`); "lut" or "canonical" the step decoders'
    counting pass, the same surplus check, and their decode."""
    dev = resolve_device(device)
    table, words, gaps, original_size = read_yamamoto(buf)
    if original_size == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    dec = device_dec_table(table, two_level=False, device=dev)
    spec = dec_spec(table)
    gaps_t = torch.from_numpy(gaps.astype(np.int32)).to(dev)
    if method in (None, "pallas"):
        return decode_yamamoto_device(
            torch.from_numpy(words.view(np.int32)).to(dev), gaps_t,
            original_size, dec, spec)
    # two zero pad words past the payload, as the JAX package reads it
    words_t = torch.from_numpy(
        np.concatenate([words, np.zeros(2, np.uint32)]).view(np.int32)).to(dev)
    counts = step.count_segments(
        words_t, gaps_t, words.size * 32, dec, spec=spec,
        seg_bits=_SEGMENT_BITS, max_count=_SEGMENT_BITS // spec.min_len + 1,
        method=method)
    total, last, top = (torch.stack([counts.sum(dtype=torch.int64),
                                     counts[-1].long(), counts.max().long()])
                        .tolist() if gaps.size else (0, 0, 0))
    excess = total - original_size
    if excess < 0 or excess > last:
        raise ValueError("corrupt container: symbol count mismatch")
    counts[-1] -= excess
    return step.decode_block(
        words_t, gaps_t, counts, dec, spec=spec, seg_bits=_SEGMENT_BITS,
        max_count=top, out_size=original_size, method=method)
