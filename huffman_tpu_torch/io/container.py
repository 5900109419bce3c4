"""The ILS1 and HTC1 containers, byte-identical to the JAX package's
writers and readers (`huffman_tpu/io/container.py`), with the same errors.

`IlsStreamWriter` and `IlsStreamReader` write and read the same ILS1 bytes
one section at a time, for the codec's file paths.

ILS1 layout (little-endian):

    magic          4s  b"ILS1"
    version        u8  3, or 4 when any section is rotated (v4 adds the
                       per-section flags word: bit0 = lane rotation, bits
                       8-11 = ILS_ROT_SUB and 12-19 = ILS_ROT_LANE)
    max_len        u8
    n_sym          u16
    original_size  u64
    n_sections     u8
    crc32          u32 over str(original_size) then every section's payload
    n_sym x (symbol u8, length u8)     # canonical order
    per section:
      k u32, snum u32, flags i32 (v3: reserved 0), w_band u32, w_cap u32,
      n_tiles u32
      n_tiles x w_tile u32
      n_tiles x n_win(k) x boff i32   # windowed decode band anchors
      payload u32 x (sum(w_tiles) * 1024)

HTC1 layout (little-endian), the gap-array codec's:

    magic            4s   b"HTC1"
    version          u8   2 (v2 adds the crc32 field; v1 readable)
    flags            u8   bit0: segments carry counts
    log2_seg_bits    u8
    max_len          u8
    n_sym            u16
    crc32            u32  (v2) over str(original_size), then every block's
                          segment metadata and payload
    n_sym x (symbol u8, length u8)      # canonical order
    original_size    u64
    block_bytes      u32
    n_blocks         u32
    n_blocks x total_bits u64
    per block:
      seg metadata   u16 x ceil(total_bits/seg_bits): (count << 4) | gap
      payload        u32 x ceil(total_bits/32)
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import torch

from ..constants import COUNT_BITS, GAP_BITS
from ..core.canonical import CodeTable, canonical_code_table
from ..core.ils_ref import (
    ILS_LANES,
    ILS_ROT_LANE,
    ILS_ROT_SUB,
    IlsParams,
    ils_n_win,
)
from ..utils import trace

__all__ = [
    "write_container",
    "read_container",
    "container_size",
    "container_kind",
    "write_ils_container",
    "read_ils_container",
    "ils_container_size",
    "IlsStreamWriter",
    "IlsStreamReader",
]

MAGIC = b"HTC1"
ILS_MAGIC = b"ILS1"
_HEADER = struct.Struct("<4sBBBBH")
_SIZES = struct.Struct("<QII")
_ILS_HEADER = struct.Struct("<4sBBHQBI")  # trailing u32: crc32 of payloads
_ILS_SECTION = struct.Struct("<IIiIII")
_ROT_FLAGS = 1 | (ILS_ROT_SUB << 8) | (ILS_ROT_LANE << 12)


def _table_entries(table: CodeTable) -> np.ndarray:
    syms = table.symtab
    out = np.empty((len(syms), 2), np.uint8)
    out[:, 0] = syms
    out[:, 1] = table.lengths[syms]
    return out


def _crc(original_size: int, payloads) -> int:
    with trace.span("io.crc"):
        crc = zlib.crc32(str(original_size).encode())
        for p in payloads:
            crc = zlib.crc32(p, crc)
        return crc & 0xFFFFFFFF


def container_kind(buf: bytes) -> str:
    """"htc1" | "ils1" from the magic, else ValueError."""
    head = bytes(buf[:4])
    if head == MAGIC:
        return "htc1"
    if head == ILS_MAGIC:
        return "ils1"
    raise ValueError("unknown container magic")


# ----------------------------------------------------------------------
# HTC1
# ----------------------------------------------------------------------
def _htc_block_parts(comp):
    for words, gaps, counts in zip(comp.block_words, comp.block_gaps,
                                   comp.block_counts):
        # the u16 holds a count of COUNT_BITS bits; a larger one would wrap
        # into a container that no reader decodes (ROADMAP.md F16), which
        # the JAX package writes without a word
        if counts.size and int(counts.max()) >= 1 << COUNT_BITS:
            raise ValueError(
                f"an HTC1 segment holds {int(counts.max())} codewords, over "
                f"the container's {COUNT_BITS}-bit count; use a smaller "
                f"seg_bits than {comp.seg_bits}")
        meta = (counts.astype(np.uint16) << GAP_BITS) | gaps.astype(np.uint16)
        yield meta.tobytes()
        yield words.astype(np.uint32).tobytes()


def container_size(comp) -> int:
    size = (_HEADER.size + 4 + 2 * comp.table.num_symbols + _SIZES.size
            + 8 * comp.n_blocks)
    for tb in comp.block_total_bits:
        size += 2 * -(-tb // comp.seg_bits) + 4 * -(-tb // 32)
    return size


def write_container(comp) -> bytes:
    """Serialize a gap-codec `Compressed` (host arrays) as HTC1 v2."""
    log2_seg = comp.seg_bits.bit_length() - 1
    if 1 << log2_seg != comp.seg_bits:
        raise ValueError("seg_bits must be a power of two")
    blocks = list(_htc_block_parts(comp))  # materialize once: CRC + body
    return b"".join([
        _HEADER.pack(MAGIC, 2, 1, log2_seg, comp.table.max_len,
                     comp.table.num_symbols),
        struct.pack("<I", _crc(comp.original_size, blocks)),
        _table_entries(comp.table).tobytes(),
        _SIZES.pack(comp.original_size, comp.block_bytes, comp.n_blocks),
        np.asarray(comp.block_total_bits, np.uint64).tobytes(),
        *blocks,
    ])


def read_container(buf: bytes):
    """Parse an HTC1 container (v1 or v2) into a host `Compressed`."""
    from ..models.gap_codec import Compressed

    mv = memoryview(buf)
    if len(buf) < _HEADER.size or bytes(mv[:4]) != MAGIC:
        raise ValueError("not an HTC1 container (bad magic)")
    _, version, _, log2_seg, max_len, n_sym = _HEADER.unpack_from(mv, 0)
    if version not in (1, 2):
        raise ValueError(f"unsupported container version {version}")
    off = _HEADER.size
    crc_stored = None
    if version >= 2:
        (crc_stored,) = struct.unpack_from("<I", mv, off)
        off += 4
    entries = np.frombuffer(mv, np.uint8, 2 * n_sym, off).reshape(n_sym, 2)
    off += 2 * n_sym
    lengths = np.zeros(256, np.uint8)
    lengths[entries[:, 0]] = entries[:, 1]
    table = canonical_code_table(lengths, max_len)

    original_size, block_bytes, n_blocks = _SIZES.unpack_from(mv, off)
    off += _SIZES.size
    total_bits = np.frombuffer(mv, np.uint64, n_blocks, off).astype(np.int64)
    off += 8 * n_blocks

    seg_bits = 1 << log2_seg
    comp = Compressed(
        table=table, seg_bits=seg_bits, original_size=int(original_size),
        block_bytes=int(block_bytes), block_words=[],
        block_total_bits=[int(t) for t in total_bits], block_gaps=[],
        block_counts=[],
    )
    for tb in comp.block_total_bits:
        n_segs = -(-tb // seg_bits)
        n_words = -(-tb // 32)
        if off + 2 * n_segs + 4 * n_words > len(buf):
            raise ValueError("truncated HTC1 container")
        meta = np.frombuffer(mv, np.uint16, n_segs, off)
        off += 2 * n_segs
        comp.block_gaps.append((meta & ((1 << GAP_BITS) - 1)).astype(np.uint8))
        comp.block_counts.append((meta >> GAP_BITS).astype(np.int32))
        comp.block_words.append(np.frombuffer(mv, np.uint32, n_words, off).copy())
        off += 4 * n_words
    if off != len(buf):
        raise ValueError(f"container has {len(buf) - off} trailing bytes")
    if crc_stored is not None and \
            _crc(comp.original_size, _htc_block_parts(comp)) != crc_stored:
        raise ValueError("HTC1 container payload checksum mismatch")
    return comp


# ----------------------------------------------------------------------
# ILS1
# ----------------------------------------------------------------------
def ils_container_size(comp) -> int:
    size = _ILS_HEADER.size + 2 * comp.table.num_symbols
    for sec in comp.sections:
        p = sec.params
        size += (
            _ILS_SECTION.size
            + 4 * p.n_tiles * (1 + ils_n_win(p.k))
            + sec.nbytes_payload
        )
    return size


def write_ils_container(comp) -> bytes:
    """Serialize an `IlsCompressed`; device payloads come to the host."""
    buf = io.BytesIO()
    writer = IlsStreamWriter(buf, comp.table, comp.original_size)
    for sec in comp.sections:
        writer.write_section(sec)
    writer.close()
    return buf.getvalue()


def _check_ils_flags(version: int, flags: int) -> None:
    if version == 3 and flags:
        # v3 reserves the flags word as zero: rejecting here catches a
        # metadata bit flip the payload CRC cannot see
        raise ValueError(f"unknown ILS section flags {flags:#x}")
    if version >= 4 and flags not in (0, _ROT_FLAGS):
        # a rotation layout these kernels do not implement must be
        # rejected, not silently mis-decoded
        raise ValueError(
            f"unsupported ILS section flags {flags:#x} (this reader "
            f"implements rotation constants sub={ILS_ROT_SUB}, "
            f"lane={ILS_ROT_LANE})")


class IlsStreamWriter:
    """Write an ILS1 container to a seekable file one section at a time.

    Each section's metadata and payload are appended as soon as they are
    written; the header (version, section count, CRC across the sections)
    is patched on `close()`.  The bytes equal `write_ils_container`'s of
    the same sections."""

    def __init__(self, fileobj, table, original_size: int):
        self.f = fileobj
        self.table = table
        self.original_size = int(original_size)
        self.n_sections = 0
        self.any_rot = False
        self.crc = zlib.crc32(str(self.original_size).encode())
        self._hdr_pos = self.f.tell()
        self.f.write(b"\0" * _ILS_HEADER.size)
        self.f.write(_table_entries(table).tobytes())

    def write_section(self, sec) -> None:
        """Append one `IlsSection`; a device payload comes to the host."""
        p = sec.params
        payload = np.ascontiguousarray(sec.payload_u32())
        self.f.write(_ILS_SECTION.pack(p.k, p.snum, _ROT_FLAGS if p.rot else 0,
                                       p.w_band, p.w_cap, p.n_tiles))
        self.f.write(p.w_tiles.astype(np.uint32).tobytes())
        self.f.write(p.boffs.astype(np.int32).tobytes())
        self.crc = zlib.crc32(payload, self.crc)
        self.f.write(payload.tobytes())
        self.any_rot = self.any_rot or bool(p.rot)
        self.n_sections += 1

    def close(self) -> None:
        # v3 readers reject v4, which any rotated section requires; plain
        # sections keep writing v3 for older readers
        end = self.f.tell()
        self.f.seek(self._hdr_pos)
        self.f.write(_ILS_HEADER.pack(
            ILS_MAGIC, 4 if self.any_rot else 3, self.table.max_len,
            self.table.num_symbols, self.original_size, self.n_sections,
            self.crc & 0xFFFFFFFF))
        self.f.seek(end)


class IlsStreamReader:
    """Read an ILS1 container from a file one section at a time.

    `read_section()` returns the next `IlsSection` (None past the last),
    its payload a CPU int32 tensor.  The payload CRC accumulates as the
    sections stream, and `close()` raises on a mismatch, on sections left
    unread and on trailing bytes: a caller that streams its output to disk
    sees that error after its last write."""

    def __init__(self, fileobj):
        self.f = fileobj
        hdr = self.f.read(_ILS_HEADER.size)
        if len(hdr) < _ILS_HEADER.size or hdr[:4] != ILS_MAGIC:
            raise ValueError("not an ILS1 container (bad magic)")
        (_, self.version, max_len, n_sym, self.original_size,
         self.n_sections, self._crc_stored) = _ILS_HEADER.unpack(hdr)
        if self.version not in (3, 4):
            raise ValueError(
                f"unsupported ILS container version {self.version}")
        ebuf = self.f.read(2 * n_sym)
        if len(ebuf) < 2 * n_sym:
            raise ValueError("truncated ILS1 container")
        entries = np.frombuffer(ebuf, np.uint8).reshape(n_sym, 2)
        lengths = np.zeros(256, np.uint8)
        lengths[entries[:, 0]] = entries[:, 1]
        self.table = canonical_code_table(lengths, max_len)
        self._read = 0
        self.crc = zlib.crc32(str(int(self.original_size)).encode())

    def _take(self, n: int) -> bytes:
        buf = self.f.read(n)
        if len(buf) < n:
            raise ValueError("truncated ILS1 container")
        return buf

    def read_section(self):
        from ..ops.ils import IlsSection

        if self._read >= self.n_sections:
            return None
        k, snum, flags, w_band, w_cap, n_tiles = _ILS_SECTION.unpack(
            self._take(_ILS_SECTION.size))
        _check_ils_flags(self.version, flags)
        n_win = ils_n_win(int(k))
        meta = self._take(4 * n_tiles * (1 + n_win))
        w_tiles = np.frombuffer(meta, np.uint32, n_tiles).astype(np.int32)
        boffs = (np.frombuffer(meta, np.int32, n_tiles * n_win, 4 * n_tiles)
                 .reshape(n_tiles, n_win).copy())
        total_rows = int(w_tiles.sum())
        payload = (np.frombuffer(self._take(4 * total_rows * ILS_LANES),
                                 np.uint32)
                   .reshape(total_rows, ILS_LANES).copy())
        self.crc = zlib.crc32(payload, self.crc)
        self._read += 1
        return IlsSection(
            params=IlsParams(
                k=int(k), snum=int(snum), boffs=boffs, w_band=int(w_band),
                w_cap=int(w_cap), w_tiles=w_tiles, n_tiles=int(n_tiles),
                rot=bool(flags & 1)),
            payload=torch.from_numpy(payload.view(np.int32)),
        )

    def close(self) -> None:
        if self._read != self.n_sections:
            raise ValueError("close() before all sections were read")
        if self.f.read(1):
            raise ValueError("container has trailing bytes")
        if (self.crc & 0xFFFFFFFF) != self._crc_stored:
            raise ValueError("ILS1 container payload checksum mismatch")


def read_ils_container(buf: bytes):
    """Parse an ILS1 container; payloads land as CPU int32 tensors."""
    with trace.span("io.parse"):
        return _parse_ils(buf)


def _parse_ils(buf: bytes):
    from ..models.ils_codec import IlsCompressed
    from ..ops.ils import IlsSection

    mv = memoryview(buf)
    if len(buf) < _ILS_HEADER.size or bytes(mv[:4]) != ILS_MAGIC:
        raise ValueError("not an ILS1 container (bad magic)")
    (_, version, max_len, n_sym, original_size, n_sections,
     crc_stored) = _ILS_HEADER.unpack_from(mv, 0)
    if version not in (3, 4):
        raise ValueError(f"unsupported ILS container version {version}")
    off = _ILS_HEADER.size
    entries = np.frombuffer(mv, np.uint8, 2 * n_sym, off).reshape(n_sym, 2)
    off += 2 * n_sym
    lengths = np.zeros(256, np.uint8)
    lengths[entries[:, 0]] = entries[:, 1]
    table = canonical_code_table(lengths, max_len)

    sections = []
    payloads = []
    for _ in range(n_sections):
        if off + _ILS_SECTION.size > len(buf):
            raise ValueError("truncated ILS1 container")
        k, snum, flags, w_band, w_cap, n_tiles = _ILS_SECTION.unpack_from(
            mv, off
        )
        _check_ils_flags(version, flags)
        off += _ILS_SECTION.size
        w_tiles = np.frombuffer(mv, np.uint32, n_tiles, off).astype(np.int32)
        off += 4 * n_tiles
        n_win = ils_n_win(int(k))
        boffs = (
            np.frombuffer(mv, np.int32, n_tiles * n_win, off)
            .reshape(n_tiles, n_win)
            .copy()
        )
        off += 4 * n_tiles * n_win
        total_rows = int(w_tiles.sum())
        n_words = total_rows * ILS_LANES
        if off + 4 * n_words > len(buf):
            raise ValueError("truncated ILS1 container")
        payload = (
            np.frombuffer(mv, np.uint32, n_words, off).reshape(total_rows, ILS_LANES)
        ).copy()
        off += 4 * n_words
        params = IlsParams(
            k=int(k),
            snum=int(snum),
            boffs=boffs,
            w_band=int(w_band),
            w_cap=int(w_cap),
            w_tiles=w_tiles,
            n_tiles=int(n_tiles),
            rot=bool(flags & 1),
        )
        payloads.append(payload)
        sections.append(IlsSection(
            params=params, payload=torch.from_numpy(payload.view(np.int32)),
        ))
    if off != len(buf):
        raise ValueError(f"container has {len(buf) - off} trailing bytes")
    if _crc(int(original_size), payloads) != crc_stored:
        raise ValueError("ILS1 container payload checksum mismatch")
    return IlsCompressed(
        table=table, original_size=int(original_size), sections=sections
    )
