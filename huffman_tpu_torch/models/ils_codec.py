"""IlsCodec — the interleaved-stream codec pipeline on PyTorch.

Counterpart of `huffman_tpu/models/ils_codec.py`.  ``fit`` is host NumPy
(histogram, package-merge lengths, canonical table, ``pick_k``); ``encode``
and ``decode`` run on the codec's device, CUDA by default.  The stream is
cut into main sections of uniform ``k`` (at most ``SECTION_BYTES`` each)
plus at most one zero-padded tail section with a smaller ``k``.
"""

from __future__ import annotations

import dataclasses

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
    _as_bytes,
    ils_decode_device,
    ils_encode_device,
    pick_k,
    resolve_device,
)
from ..ops.ils_kernels import ils_dec_tabs, ils_enc_tabs

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
        self.enc = ils_enc_tabs(table, self.device)
        self.dec = ils_dec_tabs(table, self.device)
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
        freqs = npref.histogram(data)
        return float(
            (freqs * self.table.lengths.astype(np.int64)).sum()
            / max(data.numel(), 1)
        )

    def encode(self, data) -> IlsCompressed:
        """Encode a uint8 array or tensor.  A file whose longest stream
        overflows the row budget at the chosen k halves k and re-chunks
        until it fits (MIN_K always fits)."""
        data = _as_bytes(data, self.device)
        k = self.k
        while True:
            try:
                return self._encode_with_k(data, k)
            except IlsVmemError:
                if k <= ils_ops.MIN_K:
                    raise
                k //= 2

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
            comp.sections.append(
                ils_encode_device(
                    chunk, self.table, self.enc, k=k,
                    avg_bits=self._avg_bits(chunk), rot=self.rotate,
                    device=self.device,
                )
            )
        return comp

    def decode(self, comp: IlsCompressed) -> torch.Tensor:
        """Decode to a flat uint8 tensor on the codec's device."""
        n = comp.original_size
        if n == 0:
            return torch.zeros(0, dtype=torch.uint8, device=self.device)
        outs = [
            ils_decode_device(sec, comp.table, self.dec, device=self.device)
            for sec in comp.sections
        ]
        return torch.cat(outs)[:n]

    def roundtrip_check(self, data) -> bool:
        """Self-verifying round trip, compared on the codec's device."""
        data = _as_bytes(data, self.device)
        return bool(torch.equal(self.decode(self.encode(data)), data))
