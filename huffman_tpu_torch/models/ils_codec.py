"""IlsCodec — the interleaved-stream codec pipeline on PyTorch.

Counterpart of `huffman_tpu/models/ils_codec.py`.  ``fit`` is host NumPy
(histogram, package-merge lengths, canonical table, ``pick_k``); ``encode``
and ``decode`` run on the codec's device, CUDA by default.  The stream is
cut into main sections of uniform ``k`` (at most ``SECTION_BYTES`` each)
plus at most one zero-padded tail section with a smaller ``k``.
``fit_file``, ``encode_file`` and ``decode_file`` stream a file through
the same codec one section at a time (`io.container.IlsStreamWriter` and
`IlsStreamReader`), holding at most one section's bytes on the host.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..constants import MAX_CODEWORD_LENGTH
from ..core import npref
from ..core.canonical import CodeTable, canonical_code_table
from ..core.ils_ref import ILS_LANES
from ..core.package_merge import package_merge_lengths
from ..ops import ils as ils_ops
from ..ops.ils import (
    IlsSection,
    IlsVmemError,
    ils_decode_device,
    ils_encode_device,
    pick_k,
)
from ..ops.launch import as_device_bytes, resolve_device
from ..ops.tables import ils_dec_tabs, ils_enc_tabs
from ..utils import trace

__all__ = ["IlsCompressed", "IlsCodec"]


@dataclasses.dataclass
class IlsCompressed:
    """Compressed representation: table + ILS sections."""

    table: CodeTable
    original_size: int
    sections: list[IlsSection]

    @property
    def compressed_bytes(self) -> int:
        from ..io.container import ils_container_size

        return ils_container_size(self)


class IlsCodec:
    """Canonical length-limited Huffman codec over interleaved streams.

    Typical use::

        codec = IlsCodec.fit(data)     # host: histogram + tables + k choice
        comp = codec.encode(data)      # device: certified pack
        out = codec.decode(comp)       # device: one kernel per section

    ``device`` defaults to "cuda" and raises without a card; pass
    device="cpu" to run the plain PyTorch versions of the kernels.
    """

    #: max bytes per section; larger inputs split into several sections
    SECTION_BYTES = 1 << 30

    def __init__(self, table: CodeTable, *, k: int | None = None,
                 optimize: str = "speed", device="cuda",
                 rotate: bool | str = "auto"):
        self.device = resolve_device(device)
        self.table = table
        with trace.span("ils.tables"):
            self.enc = ils_enc_tabs(table, device=self.device)
            self.dec = ils_dec_tabs(table, device=self.device)
        self.k = int(k) if k else pick_k(8.0, optimize)
        # "auto" decides per section from the certified band; decode always
        # follows the container
        self.rotate = rotate if rotate == "auto" else bool(rotate)

    @classmethod
    def fit(
        cls,
        data,
        *,
        max_len: int = MAX_CODEWORD_LENGTH,
        k: int | None = None,
        optimize: str = "speed",
        device="cuda",
        rotate: bool | str = "auto",
    ) -> "IlsCodec":
        """Build the table from a uint8 array or tensor's histogram."""
        resolve_device(device)
        freqs = npref.histogram(data)
        # account for the zero padding encode() appends (worst case one tile)
        freqs[0] += 1
        table = canonical_code_table(package_merge_lengths(freqs, max_len), max_len)
        avg = float(
            (freqs * table.lengths.astype(np.int64)).sum() / max(freqs.sum(), 1)
        )
        if k is None:
            k = pick_k(avg, optimize)
        codec = cls(table, k=k, device=device, rotate=rotate)
        codec.fit_avg_bits = avg
        return codec

    def _avg_bits(self, data: torch.Tensor) -> float:
        with trace.span("ils.histogram", device=data.device):
            freqs = npref.histogram(data)
        trace.count("histogram_bytes", data.numel())
        return float(
            (freqs * self.table.lengths.astype(np.int64)).sum()
            / max(data.numel(), 1)
        )

    def encode(self, data) -> IlsCompressed:
        """Encode a uint8 array or tensor.  A file whose longest stream
        overflows the row budget at the chosen k halves k and re-chunks
        until it fits (MIN_K always fits).  The half is rounded up to a
        multiple of 4, as the format needs: the JAX package's plain
        halving wherever that stays a multiple of 4 (a k of 4 times an odd
        number, such as 4100, would halve to 2050)."""
        with trace.span("ils.encode", device=self.device):
            data = as_device_bytes(data, self.device)
            k = self.k
            while True:
                try:
                    return self._encode_with_k(data, k)
                except IlsVmemError:
                    if k <= ils_ops.MIN_K:
                        raise
                    k = -(-k // 8) * 4

    def _encode_with_k(self, data: torch.Tensor, k_main: int) -> IlsCompressed:
        n = data.numel()
        comp = IlsCompressed(table=self.table, original_size=n, sections=[])
        if n == 0:
            return comp
        tile_bytes = k_main * ILS_LANES
        n_full = n // tile_bytes
        chunks = []
        if n_full:
            sec_tiles = max(self.SECTION_BYTES // tile_bytes, 1)
            for lo in range(0, n_full, sec_tiles):
                hi = min(lo + sec_tiles, n_full)
                chunks.append((data[lo * tile_bytes : hi * tile_bytes], k_main))
        rem = n - n_full * tile_bytes
        if rem:
            k_tail = max(-(-rem // (4 * ILS_LANES)) * 4, 8)
            padded = torch.zeros(k_tail * ILS_LANES, dtype=torch.uint8,
                                 device=self.device)
            padded[:rem] = data[n_full * tile_bytes :]
            chunks.append((padded, k_tail))
        for chunk, k in chunks:
            with trace.span("ils.section", k=k,
                            n_tiles=chunk.numel() // (k * ILS_LANES)):
                comp.sections.append(
                    ils_encode_device(
                        chunk, self.table, self.enc, k=k,
                        avg_bits=self._avg_bits(chunk), rot=self.rotate,
                        device=self.device,
                    )
                )
        trace.count("ils.sections", len(comp.sections))
        return comp

    def decode(self, comp: IlsCompressed) -> torch.Tensor:
        """Decode to a flat uint8 tensor on the codec's device."""
        n = comp.original_size
        if n == 0:
            return torch.zeros(0, dtype=torch.uint8, device=self.device)
        with trace.span("ils.decode", device=self.device):
            outs = []
            for sec in comp.sections:
                with trace.span("ils.section", k=sec.params.k,
                                n_tiles=sec.params.n_tiles):
                    outs.append(ils_decode_device(sec, comp.table, self.dec,
                                                  device=self.device))
            with trace.span("ils.concat"):
                return torch.cat(outs)[:n]

    # ------------------------------------------------------------------
    # File paths, one section at a time
    # ------------------------------------------------------------------
    @classmethod
    def fit_file(
        cls,
        path: str,
        *,
        max_len: int = MAX_CODEWORD_LENGTH,
        chunk_bytes: int = 1 << 28,
        **kw,
    ) -> "IlsCodec":
        """`fit` from a file's histogram, counted on the host over
        ``chunk_bytes`` chunks (the file is never loaded whole); ``kw``
        goes to the constructor (``k``, ``optimize``, ``device``,
        ``rotate``)."""
        freqs = np.zeros(256, np.int64)
        n = 0
        with open(path, "rb") as f:
            while True:
                chunk = np.fromfile(f, np.uint8, chunk_bytes)
                if chunk.size == 0:
                    break
                freqs += np.bincount(chunk, minlength=256)
                n += chunk.size
        freqs[0] += 1  # the tail section's zero padding (as in `fit`)
        table = canonical_code_table(package_merge_lengths(freqs, max_len),
                                     max_len)
        # over the file's n bytes, where `fit` divides by n + 1 (as the JAX
        # package does)
        avg = float((freqs * table.lengths.astype(np.int64)).sum() / max(n, 1))
        if kw.get("k") is None:
            kw = dict(kw, k=pick_k(avg, kw.get("optimize", "speed")))
        kw.pop("optimize", None)
        codec = cls(table, **kw)
        codec.fit_avg_bits = avg
        return codec

    def encode_file(self, in_path: str, out_path: str, *,
                    section_bytes: int | None = None) -> int:
        """Encode a file into an ILS1 container file, one chunk of at most
        ``section_bytes`` (default SECTION_BYTES) whole tiles at a time:
        read on the host, encoded on the codec's device, appended to the
        container.  A chunk that is not whole tiles (the file's last) is
        one zero-padded tile at its own k.  Returns the container's size.

        A section over the row budget retries at half its k.  Where plain
        halving keeps k a multiple of 4 this is the JAX package's sequence
        and its bytes; where it would not (ROADMAP.md F9: a k of 4 times an
        odd number), the JAX package writes a container that no reader can
        decode.  Here the file's last chunk rounds the half up to a
        multiple of 4 and is zero-padded to whole tiles of it (the decoder
        trims the file's end); any other chunk must stay unpadded, and
        takes the largest multiple of 4 under the half that divides it."""
        from ..io.container import IlsStreamWriter

        section_bytes = section_bytes or self.SECTION_BYTES
        n = os.path.getsize(in_path)
        tile_bytes = self.k * ILS_LANES
        with open(in_path, "rb") as fin, open(out_path, "w+b") as fout:
            writer = IlsStreamWriter(fout, self.table, n)
            pos = 0
            while pos < n:
                take = min(max(section_bytes // tile_bytes, 1) * tile_bytes,
                           n - pos)
                chunk = np.fromfile(fin, np.uint8, take)
                if chunk.size != take:
                    raise ValueError(f"{in_path} changed size while encoding")
                k_sec = self.k if take % tile_bytes == 0 else max(
                    -(-take // (4 * ILS_LANES)) * 4, 8)
                pos += take
                writer.write_section(
                    self._encode_chunk(chunk, k_sec, last=pos == n))
            writer.close()
            return fout.tell()

    def _encode_chunk(self, chunk: np.ndarray, k: int, *,
                      last: bool) -> IlsSection:
        """One section of `encode_file`: the chunk's histogram once on the
        device, then the row-budget retries.  Only the file's ``last``
        chunk is zero-padded to whole tiles of its k, with the padding's
        zeros added to the count of byte 0 (the same integers as counting
        the padded chunk); any other chunk is whole tiles of every k it
        tries."""
        data = trace.to_device(chunk, self.device, "file_chunk")
        n = data.numel()
        freqs = npref.histogram(data)
        lengths = self.table.lengths.astype(np.int64)
        while True:
            tile_bytes = k * ILS_LANES
            size = -(-n // tile_bytes) * tile_bytes
            assert last or size == n
            padded = freqs.copy()
            padded[0] += size - n
            avg = float((padded * lengths).sum() / size)
            buf = data
            if size != n:
                buf = torch.zeros(size, dtype=torch.uint8, device=self.device)
                buf[:n] = data
            try:
                sec = ils_encode_device(buf, self.table, self.enc, k=k,
                                        avg_bits=avg, rot=self.rotate,
                                        device=self.device)
                trace.count("ils.sections")
                return sec
            except IlsVmemError:
                if k <= ils_ops.MIN_K:
                    raise
                if last:
                    k = -(-k // 8) * 4
                else:  # 4 always divides: the chunk is whole tiles of k
                    units = n // ILS_LANES
                    k = next(c for c in range(k // 8 * 4, 0, -4)
                             if units % c == 0)

    @classmethod
    def decode_file(cls, in_path: str, out_path: str, *,
                    device="cuda") -> int:
        """Decode an ILS1 container file to a file, one section at a time
        on ``device``; returns the decoded byte count.  The payload CRC
        accumulates across the sections, and a mismatch raises after the
        last write (write to a temporary path where that matters)."""
        from ..io.container import IlsStreamReader

        with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
            reader = IlsStreamReader(fin)
            codec = cls(reader.table, device=device)
            remaining = int(reader.original_size)
            while (sec := reader.read_section()) is not None:
                out = ils_decode_device(sec, reader.table, codec.dec,
                                        device=codec.device)
                take = min(out.numel(), remaining)
                fout.write(trace.to_host(out[:take], "file_out").numpy().data)
                remaining -= take
            reader.close()
            if remaining:
                raise ValueError(
                    f"container sections cover {remaining} bytes short of "
                    "original_size"
                )
            return int(reader.original_size)

    def roundtrip_check(self, data) -> bool:
        """Self-verifying round trip, compared on the codec's device."""
        data = as_device_bytes(data, self.device)
        return bool(torch.equal(self.decode(self.encode(data)), data))
