"""GapArrayCodec — the gap-array (HTC1) codec pipeline on PyTorch.

Counterpart of `huffman_tpu/models/gap_codec.py`.  ``fit`` is host NumPy
(histogram, package-merge lengths, canonical table).  The stream is cut
into blocks of ``block_bytes`` encoded independently, each segmented into
``seg_bits``-bit segments that carry (gap, count) metadata, so decode is
one pass.  Encode runs the kernels of `ops/gap_encode_kernels.py` for
blocks of any size, the ragged tail included (the JAX package sends
blocks that are not a multiple of 128 bytes through XLA's `encode_block`;
the bytes are the same).  Decode runs, by the
codec's ``method``, the kernel of `ops/gap_decode_kernels.py` for every
table (None or "pallas": B1 placing its bytes, `decode_blocks`) or a step decoder of `ops/decode.py` ("lut",
"canonical", "twolevel").  Both run on the codec's device, CUDA by
default.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (
    DEFAULT_BLOCK_BYTES,
    MAX_BLOCK_BYTES,
    MAX_CODEWORD_LENGTH,
    SEG_BITS,
)
from ..core import npref
from ..core.canonical import CodeTable, canonical_code_table
from ..core.package_merge import package_merge_lengths
from ..ops import decode as step
from ..ops.gap_decode_kernels import decode_blocks
from ..ops.gap_encode_kernels import encode_blocks
from ..ops.launch import as_device_bytes, resolve_device
from ..ops.tables import dec_spec, device_dec_table, device_enc_table
from ..utils import trace

__all__ = ["Compressed", "DeviceCompressed", "GapArrayCodec"]

# input bytes of the full blocks that one device group holds: encode needs
# about 7 more bytes per input byte (row words, starts, payload) and decode
# a few, so a group stays a few GiB whatever the input's size
GROUP_BYTES = 1 << 30


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


@dataclasses.dataclass
class DeviceCompressed:
    """Device-resident compressed form: G equal-size blocks, padded and
    stacked.  `GapArrayCodec.decode_device` consumes it directly;
    `GapArrayCodec.stage_host` turns it into the exact host `Compressed`."""

    table: CodeTable
    seg_bits: int
    original_size: int
    block_bytes: int
    words: torch.Tensor  # (G, max_words + 1) int32 u32 bits, zero-padded
    total_bits: torch.Tensor  # (G,) int32
    gaps: torch.Tensor  # (G, n_segs) int32
    counts: torch.Tensor  # (G, n_segs) int32


@dataclasses.dataclass
class Compressed:
    """Host-side compressed representation (exact, unpadded per block)."""

    table: CodeTable
    seg_bits: int
    original_size: int
    block_bytes: int
    block_words: list  # list[np.ndarray uint32] exact payload per block
    block_total_bits: list  # list[int]
    block_gaps: list  # list[np.ndarray uint8]
    block_counts: list  # list[np.ndarray int32]

    @property
    def n_blocks(self) -> int:
        return len(self.block_words)

    @property
    def compressed_bytes(self) -> int:
        """Size of the serialized container (header + metadata + payload)."""
        from ..io.container import container_size

        return container_size(self)


class GapArrayCodec:
    """Canonical length-limited Huffman codec with gap+count segment metadata.

    Typical use::

        codec = GapArrayCodec.fit(data)   # host: histogram + tables
        comp = codec.encode(data)          # device: block encode
        out = codec.decode(comp)           # device: one-pass decode

    ``device`` defaults to "cuda" and raises without a card; pass
    device="cpu" to run the plain PyTorch versions of the kernels.

    ``method`` picks the decoder.  None and "pallas" (the JAX package's name
    for its accelerator path, kept so that an argument means the same in
    both packages) run the CUDA kernel B1 in its placing form; "lut", "canonical" and
    "twolevel" run that step decoder of `ops/decode.py`, in `decode` and
    `decode_device` alike (the JAX package's `decode_device` takes its
    Pallas path first whatever the method; the bytes are the same).  Any
    other method raises when a decode runs, with the JAX package's message.
    """

    def __init__(self, table: CodeTable, *, seg_bits: int = SEG_BITS,
                 block_bytes: int = DEFAULT_BLOCK_BYTES,
                 method: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        if block_bytes > MAX_BLOCK_BYTES:
            raise ValueError("block_bytes too large for int32 bit offsets")
        if seg_bits & (seg_bits - 1):
            raise ValueError("seg_bits must be a power of two")
        self.table = table
        self.seg_bits = int(seg_bits)
        self.block_bytes = int(block_bytes)
        self.method = "pallas" if method is None else method
        # (len << 20) | code
        self.enc = device_enc_table(table, device=self.device)
        self.dec = device_dec_table(table, two_level=self.method == "twolevel",
                                    device=self.device)
        self.spec = dec_spec(table)

    @classmethod
    def fit(cls, data, *, max_len: int = MAX_CODEWORD_LENGTH,
            seg_bits: int = SEG_BITS, block_bytes: int = DEFAULT_BLOCK_BYTES,
            method: str | None = None, device="cuda") -> "GapArrayCodec":
        """Build the code table from a uint8 array or tensor's histogram."""
        resolve_device(device)
        lengths = package_merge_lengths(npref.histogram(data), max_len)
        return cls(canonical_code_table(lengths, max_len), seg_bits=seg_bits,
                   block_bytes=block_bytes, method=method, device=device)

    # ------------------------------------------------------------------
    def _encode_blocks(self, blocks: torch.Tensor, max_words: int, n_segs: int):
        """(G, B) uint8 blocks on the codec's device, any B >= 1 -> (words,
        total_bits, gaps, counts) with the JAX package's shapes, from the
        kernels B4b-B4d."""
        with trace.span("gap.blocks"):
            return encode_blocks(blocks, self.enc, seg_bits=self.seg_bits,
                                 max_words=max_words, n_segs=n_segs,
                                 max_len=max(self.table.max_len_present, 1))

    def encode_device(self, blocks) -> DeviceCompressed:
        """Encode a (G, B) stack of equal-size blocks (or one (B,) block),
        a uint8 array or tensor; the result stays on the device.  The
        payload is sized by the deepest code, as the data is not counted."""
        with trace.span("gap.encode", device=self.device):
            shape = (blocks.shape if isinstance(blocks, torch.Tensor)
                     else np.shape(blocks))
            blocks = as_device_bytes(blocks, self.device).view(
                shape[0] if len(shape) == 2 else 1, -1)
            g, b = blocks.shape
            max_words = _round_up(_cdiv(b * self.table.max_len_present, 32),
                                  512)
            n_segs = _cdiv(max_words * 32, self.seg_bits)
            words, total_bits, gaps, counts = self._encode_blocks(
                blocks, max_words, n_segs)
        return DeviceCompressed(
            table=self.table, seg_bits=self.seg_bits, original_size=g * b,
            block_bytes=b, words=words, total_bits=total_bits, gaps=gaps,
            counts=counts,
        )

    @staticmethod
    def decode_device_plan(dcomp: DeviceCompressed):
        """(words, gaps, counts, max_count, counts_in_range) that
        `decode_device` hands the kernels.

        The all-empty segment tail is trimmed (encode_device sizes the
        payload by the deepest code) to a multiple of 4096 segments, as the
        JAX package does.  Three scalars cross to the host in one copy: the
        last segment any block uses, the largest count and the smallest;
        max_count covers the largest, so the counts are in [0, max_count]
        where the smallest is not negative."""
        with trace.span("gap.plan"):
            counts, gaps = dcomp.counts, dcomp.gaps
            n_segs = counts.shape[1]
            used = counts.any(0) * torch.arange(1, n_segs + 1,
                                                device=counts.device)
            low, top = torch.aminmax(counts)
            last, top, low = map(int, trace.to_host(
                torch.stack([used.max(), top.to(used.dtype),
                             low.to(used.dtype)]), "plan").numpy())
            ns_used = min(_round_up(max(last, 1), 4096), n_segs)
            return (dcomp.words, gaps[:, :ns_used].contiguous(),
                    counts[:, :ns_used].contiguous(), _round_up(max(top, 1), 8),
                    low >= 0)

    def _decode_group(self, words, gaps, counts, *, seg_bits: int,
                      max_count: int, out_size: int,
                      counts_in_range: bool) -> torch.Tensor:
        """(G, out_size) uint8 from G blocks' (words, gaps, counts), by the
        codec's method: the kernels, or the step decoder block by block."""
        with trace.span("gap.group"):
            if self.method == "pallas":
                return decode_blocks(
                    words, gaps, counts, self.dec, spec=self.spec,
                    seg_bits=seg_bits, max_count=max_count, out_size=out_size,
                    counts_in_range=counts_in_range)
            return torch.stack([
                step.decode_block(w, gp, c, self.dec, spec=self.spec,
                                  seg_bits=seg_bits, max_count=max_count,
                                  out_size=out_size, method=self.method)
                for w, gp, c in zip(words, gaps, counts)])

    def decode_device(self, dcomp: DeviceCompressed) -> torch.Tensor:
        """Decode a device-resident group; returns (G, block_bytes) uint8 on
        the device.  The payload and the output never leave it."""
        with trace.span("gap.decode", device=self.device):
            words, gaps, counts, max_count, in_range = self.decode_device_plan(
                dcomp)
            return self._decode_group(words, gaps, counts,
                                      seg_bits=dcomp.seg_bits,
                                      max_count=max_count,
                                      out_size=dcomp.block_bytes,
                                      counts_in_range=in_range)

    def stage_host(self, dcomp: DeviceCompressed, comp: Compressed) -> None:
        """Append a device group's blocks to a host `Compressed` (exact,
        unpadded per block) — the container-writing path.  Only the words
        and segments up to the longest block's bits cross to the host."""
        total_bits = trace.to_host(dcomp.total_bits, "stage_host").numpy()
        top = int(total_bits.max(initial=0))
        seg_bits = dcomp.seg_bits
        words = trace.to_host(dcomp.words[:, : _cdiv(top, 32)],
                              "stage_host").numpy().view(np.uint32)
        gaps = trace.to_host(dcomp.gaps[:, : _cdiv(top, seg_bits)],
                             "stage_host").numpy()
        counts = trace.to_host(dcomp.counts[:, : _cdiv(top, seg_bits)],
                               "stage_host").numpy()
        for i in range(total_bits.shape[0]):
            tb = int(total_bits[i])
            ns = _cdiv(tb, seg_bits)
            comp.block_words.append(words[i, : _cdiv(tb, 32)].copy())
            comp.block_total_bits.append(tb)
            comp.block_gaps.append(gaps[i, :ns].astype(np.uint8))
            comp.block_counts.append(counts[i, :ns].copy())

    @staticmethod
    def _groups(n_full: int, block_bytes: int):
        """Ranges of full blocks, each one device group of at most
        GROUP_BYTES of input (one block at the least)."""
        step = max(GROUP_BYTES // block_bytes, 1)
        return [range(lo, min(lo + step, n_full)) for lo in range(0, n_full, step)]

    def encode(self, data) -> Compressed:
        """Encode a uint8 array or tensor into a host `Compressed`: the
        full blocks in device groups of at most GROUP_BYTES, then the tail
        as one block of its own size, each through the kernels.  (The JAX package sizes its groups by their exact bit
        count; the bytes do not depend on the grouping or the sizing.)"""
        with trace.span("gap.encode", device=self.device):
            data = as_device_bytes(data, self.device)
            n = data.numel()
            comp = Compressed(
                table=self.table, seg_bits=self.seg_bits, original_size=n,
                block_bytes=self.block_bytes, block_words=[],
                block_total_bits=[], block_gaps=[], block_counts=[],
            )
            bb = self.block_bytes
            n_full = n // bb
            for grp in self._groups(n_full, bb):
                blocks = data[grp.start * bb : grp.stop * bb].view(len(grp), bb)
                self.stage_host(self.encode_device(blocks), comp)
            if n % bb:
                self.stage_host(self.encode_device(data[n_full * bb :]), comp)
            return comp

    # ------------------------------------------------------------------
    def decode_plan(self, comp: Compressed, idxs):
        """(words, gaps, counts, max_count, counts_in_range) that `decode`
        hands the kernels for the host blocks `idxs`: each block's exact
        words and segments, zero-padded to the group's longest, on the
        codec's device (`decode_device_plan`)."""
        max_w = max(comp.block_words[i].size for i in idxs)
        max_s = max(comp.block_gaps[i].size for i in idxs)
        g = len(idxs)
        words = np.zeros((g, max_w + 1), np.uint32)
        gaps = np.zeros((g, max_s), np.int32)
        counts = np.zeros((g, max_s), np.int32)
        for j, i in enumerate(idxs):
            words[j, : comp.block_words[i].size] = comp.block_words[i]
            gaps[j, : comp.block_gaps[i].size] = comp.block_gaps[i]
            counts[j, : comp.block_counts[i].size] = comp.block_counts[i]
        return (*(trace.to_device(x, self.device, "plan_host")
                  for x in (words.view(np.int32), gaps, counts)),
                _round_up(max(int(counts.max(initial=0)), 1), 8),
                int(counts.min(initial=0)) >= 0)

    def decode(self, comp: Compressed) -> torch.Tensor:
        """Decode to a flat uint8 tensor on the codec's device, the full
        blocks in groups as `encode` makes them, then the tail."""
        with trace.span("gap.decode", device=self.device):
            n = comp.original_size
            bb = comp.block_bytes
            n_full = n // bb
            out = torch.empty(n, dtype=torch.uint8, device=self.device)
            groups = [(grp, bb) for grp in self._groups(n_full, bb)]
            if n % bb:
                groups.append(([comp.n_blocks - 1], n % bb))
            for grp, out_size in groups:
                words, gaps, counts, max_count, in_range = self.decode_plan(
                    comp, grp)
                lo = grp[0] * bb
                out[lo : lo + len(grp) * out_size] = self._decode_group(
                    words, gaps, counts, seg_bits=comp.seg_bits,
                    max_count=max_count, out_size=out_size,
                    counts_in_range=in_range).view(-1)
            return out

    def roundtrip_check(self, data) -> bool:
        """Self-verifying round trip, compared on the codec's device."""
        data = as_device_bytes(data, self.device)
        return bool(torch.equal(self.decode(self.encode(data)), data))
