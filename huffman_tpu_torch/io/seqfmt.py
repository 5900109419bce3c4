"""sequential.cpp format interop: the reference's ground-truth codec format.

Counterpart of `huffman_tpu/io/seqfmt.py`, byte-exact with it.  The blob
(`sequential.cpp:163-204`) is

    padding    u8            # zero bits appended to reach a byte boundary
    num_codes  u16 BIG-endian
    num_codes x (symbol u8, code_len u8, code as ASCII '0'/'1' chars)
    payload    bytes, MSB-first

The reference's codes come from a greedy Huffman tree whose tie-breaking
depends on unordered_map iteration order, so they are an arbitrary prefix
code.  The reader accepts any prefix code: canonical codes of at most 16
bits decode through self-sync on the device (`models/selfsync.py`), others
through the host LUT walk.  The writer emits canonical codes, a valid
instance of the format.  The host walk is the NumPy loop only (the JAX
package's optional native helper gives the same bytes faster).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import npref
from ..core.canonical import CodeTable, build_flat_lut
from ..ops.launch import resolve_device

__all__ = [
    "PrefixCode",
    "write_seq",
    "read_seq_header",
    "decode_seq",
    "host_lut_decode",
]


@dataclasses.dataclass(frozen=True)
class PrefixCode:
    """An arbitrary (not necessarily canonical) binary prefix code."""

    lengths: np.ndarray  # (256,) uint8, 0 = absent
    codes: np.ndarray  # (256,) uint32 right-aligned

    @property
    def max_len(self) -> int:
        return int(self.lengths.max(initial=0))

    def flat_lut(self):
        syms = np.nonzero(self.lengths > 0)[0]
        shim = CodeTable(
            lengths=self.lengths,
            codes=self.codes,
            max_len=max(self.max_len, 1),
            symtab=syms.astype(np.uint8),
            counts=np.zeros(1, np.int32),
            first_code=np.zeros(1, np.uint32),
            offsets=np.zeros(1, np.int32),
            lim_left=np.zeros(1, np.uint32),
        )
        return build_flat_lut(shim, self.max_len)


def write_seq(data: np.ndarray, table: CodeTable) -> bytes:
    """Encode bytes into a sequential.cpp-format blob (canonical codes)."""
    data = np.asarray(data, np.uint8)
    if data.size == 0:
        return b""
    words, total_bits = npref.encode_bits(data, table)
    n_bytes = -(-total_bits // 8)
    padding = n_bytes * 8 - total_bits
    payload = words.astype(">u4").tobytes()[:n_bytes]  # MSB-first byte stream

    syms = table.symtab
    parts = [bytes([padding]), len(syms).to_bytes(2, "big")]
    for s in syms:
        l = int(table.lengths[s])
        bits = format(int(table.codes[s]), f"0{l}b").encode("ascii")
        parts.append(bytes([int(s), l]) + bits)
    parts.append(payload)
    return b"".join(parts)


def read_seq_header(buf: bytes):
    """Parse the header. Returns (code: PrefixCode, payload_off, total_bits)."""
    if len(buf) < 3:
        raise ValueError("truncated sequential-format blob")
    padding = buf[0]
    if padding > 7:
        raise ValueError("invalid padding")
    n = int.from_bytes(buf[1:3], "big")
    lengths = np.zeros(256, np.uint8)
    codes = np.zeros(256, np.uint32)
    off = 3
    for _ in range(n):
        if off + 2 > len(buf):
            raise ValueError("truncated code table")
        sym, l = buf[off], buf[off + 1]
        off += 2
        if l == 0 or l > 32 or off + l > len(buf):
            raise ValueError("invalid code entry")
        bits = buf[off : off + l]
        off += l
        code = 0
        for c in bits:
            if c not in (0x30, 0x31):
                raise ValueError("invalid code character")
            code = (code << 1) | (c - 0x30)
        lengths[sym] = l
        codes[sym] = code
    total_bits = (len(buf) - off) * 8 - padding
    if total_bits < 0:
        raise ValueError("truncated payload")
    return PrefixCode(lengths=lengths, codes=codes), off, total_bits


def host_lut_decode(payload: np.ndarray, total_bits: int,
                    code: PrefixCode) -> np.ndarray:
    """Host sequential LUT walk for any prefix code (MSB-first stream), the
    role of the reference's bit-by-bit decode loop (`sequential.cpp:88-94`):
    in C (`native.decode_prefix_lut`) where the native host module builds,
    else a NumPy loop (slow, for small inputs)."""
    payload = np.asarray(payload, np.uint8)
    if total_bits == 0:
        return np.zeros(0, np.uint8)
    lut_sym, lut_len = code.flat_lut()
    b = code.max_len
    from .. import native

    if native.available() and 1 <= b <= 24:
        present = code.lengths[code.lengths > 0]
        min_len = int(present.min()) if present.size else 1
        return native.decode_prefix_lut(payload, total_bits, lut_sym, lut_len,
                                        b, out_cap=total_bits // min_len + 1)
    bits = np.unpackbits(payload)[:total_bits]
    bits = np.concatenate([bits, np.zeros(b, np.uint8)])
    weights = 1 << np.arange(b - 1, -1, -1)
    out = []
    pos = 0
    while pos < total_bits:
        window = int(bits[pos : pos + b] @ weights)
        l = int(lut_len[window])
        if l == 0:
            raise ValueError("corrupt stream: no codeword matches")
        out.append(lut_sym[window])
        pos += l
    return np.asarray(out, np.uint8)


def decode_seq(buf: bytes, *, selfsync: bool = True, device="cuda") -> torch.Tensor:
    """Decode a sequential.cpp-format blob to a uint8 tensor on `device`
    (CUDA unless the caller asks for the CPU).

    ``selfsync=True`` finds the codeword boundaries with the
    self-synchronising decoder (no encoder-side metadata needed);
    ``selfsync=False`` runs the host LUT walk (for small inputs).  The JAX
    package calls this switch ``device``, and a bool ``device`` means what
    it means there: ``True`` the self-synchronising decoder on the card,
    ``False`` the host walk, its bytes on the CPU."""
    if isinstance(device, bool):
        selfsync, device = device, "cuda" if device else "cpu"
    dev = resolve_device(device)
    if len(buf) == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    code, off, total_bits = read_seq_header(buf)
    payload = np.frombuffer(buf, np.uint8, offset=off)
    if selfsync:
        from ..models.selfsync import selfsync_decode_bytes

        return selfsync_decode_bytes(payload, total_bits, code, device=dev)
    return torch.from_numpy(host_lut_decode(payload, total_bits, code)).to(dev)
