"""Sharded interleaved-stream (ILS) codec: the tile axis over the ranks.

Counterpart of `huffman_tpu/parallel/ils.py`.  Tiles are independent given
the replicated code table, so each rank encodes and decodes its contiguous
range of ``tiles_per_device`` tiles with the port's kernels (A2 and A3 for
the certified encode, A5 for the full-band pack, A1 for every decode) on
its own device.  Each function takes and returns the rank's local shard in
the flat lane layout ``(rows, 1024)`` int32; `mesh.gather_shards` gives
the rank-ordered whole.  `IlsShardedCodec` drives them as `IlsCodec` is
driven: a table fitted on the global histogram, each rank's bytes encoded
to its shard, the decode and the ILS1 container of the whole stream in
rank order.

Every branch that depends on the data is taken on a value reduced over
all ranks (the fused pass's violation flag, the certified params), so
all ranks take it together: a rank that raised alone would leave the
others waiting in a collective.

The round trip runs in *full-band* mode (``w_band == w_cap // 2``, every
row of a tile in the window), which is correct without a certification
pass; the certified encode is the codec's banded configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import DataMesh, all_reduce, gather_ragged, gather_shards, on_mesh
from ..constants import MAX_CODEWORD_LENGTH
from ..core.canonical import CodeTable, canonical_code_table
from ..core.ils_ref import ILS_LANES, IlsParams, ils_n_win, ils_schedule_numer
from ..core.package_merge import package_merge_lengths
from ..io.container import write_ils_container
from ..models.ils_codec import IlsCompressed
from ..ops.histogram_kernels import byte_counts
from ..ops.ils import (
    IlsSection,
    auto_rot_band,
    fused_certify,
    fused_e_band,
    fused_pass_for,
    pick_k,
    stride_rows_for,
)
from ..ops.ils_kernels import ils_compact, ils_decode, ils_pack
from ..ops.launch import as_device_bytes
from ..ops.tables import IlsDecTabs, ils_dec_tabs, ils_enc_tabs
from ..utils import trace

__all__ = [
    "shard_ils_payload",
    "make_ils_sharded_decode",
    "make_ils_sharded_roundtrip",
    "ils_sharded_certified_encode",
    "IlsShardedSection",
    "IlsShardedCodec",
]


def _cdiv(a, b):
    return -(-a // b)


def shard_ils_payload(payload, row_starts: np.ndarray, w_cap: int,
                      n_devices: int):
    """Repartition a compact ILS payload for a D-way tile shard (host
    NumPy).

    payload: (total_rows, 1024) compact rows (a uint32 or int32 array, or
    a tensor); row_starts: (n_tiles + 1,) row offset per tile (the cumsum
    of w_tiles); n_tiles must be a multiple of D.  Returns (payload_dev
    (D, R_dev, 1024) int32, starts_dev (D, T/D) int32): rank d decodes
    ``payload_dev[d]`` from ``starts_dev[d]``; R_dev includes w_cap zero
    slack rows."""
    if isinstance(payload, torch.Tensor):
        payload = payload.cpu().numpy()
    n_tiles = len(row_starts) - 1
    if n_tiles % n_devices:
        raise ValueError(f"{n_tiles} tiles not divisible by {n_devices} devices")
    tpd = n_tiles // n_devices
    rows = np.ascontiguousarray(payload).view(np.int32).reshape(-1, ILS_LANES)
    bounds = np.asarray(row_starts, np.int64)[::tpd]
    r_dev = int(np.diff(bounds).max()) + w_cap
    payload_dev = np.zeros((n_devices, r_dev, ILS_LANES), np.int32)
    starts_dev = np.zeros((n_devices, tpd), np.int32)
    for d in range(n_devices):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        payload_dev[d, : hi - lo] = rows[lo:hi]
        starts_dev[d] = np.asarray(row_starts[d * tpd: (d + 1) * tpd]) - lo
    return payload_dev, starts_dev


def make_ils_sharded_decode(
    mesh: DataMesh,
    *,
    k: int,
    w_cap: int,
    w_band: int,
    max_len: int,
    tiles_per_device: int,
    min_len: int = 1,
    rot: bool = False,
    chain: tuple | None = None,
):
    """Sharded ILS decode: fn(payload, starts, params, boffs, dec) ->
    (tiles_per_device * k//4, 1024) int32, the rank's tiles, whose u32
    view is its part of the original stream.

    payload (R_dev, 1024) int32 and starts (tiles_per_device,) int32 are
    the rank's shard (`shard_ils_payload`, `IlsShardedSection`); ``dec``
    the `ils_dec_tabs` of the table.  ``params`` (snum) and ``boffs`` (the
    rank's (tiles_per_device, n_win) band anchors) keep the JAX call form
    and are not read: the port's A1 loads each pair directly, which the
    certified band makes equivalent to the banded window, so the band is
    checked here once, as `ops/ils.py::ils_decode_device` checks it.
    ``chain`` is accepted and ignored: A1 takes each codeword's length from
    its table, not from a grouped compare chain."""
    if not 1 <= w_band <= w_cap // 2:
        raise ValueError(f"invalid ILS section: w_band={w_band} outside "
                         f"[1, w_cap//2={w_cap // 2}]")

    def dec_fn(payload, starts, params, boffs, dec: IlsDecTabs) -> torch.Tensor:
        on_mesh(mesh, payload, starts, *dec)
        return ils_decode(payload, starts, dec, k=k, w_cap=w_cap,
                          n_tiles=tiles_per_device, max_len=max_len,
                          min_len=min_len, rot=rot)

    return dec_fn


@dataclasses.dataclass
class IlsShardedSection:
    """A certified section, sharded: this rank's compact payload and row
    starts, and the global certified params (one w_cap and w_band on every
    rank)."""

    payload_dev: torch.Tensor  # (R_dev, 1024) int32, this rank's rows
    starts_dev: torch.Tensor  # (tiles_per_device,) int32 local row starts
    params: IlsParams  # global; boffs is (D * tiles_per_device, n_win)


def ils_sharded_certified_encode(
    mesh: DataMesh,
    data_dev: torch.Tensor,
    enc: torch.Tensor,
    *,
    k: int,
    max_len: int,
    avg_bits: float,
    tiles_per_device: int,
    rot: bool = False,
) -> IlsShardedSection:
    """Certified sharded encode, the codec's configuration on D ranks.

    data_dev: the rank's (tiles_per_device * k//4, 1024) int32 words.  Each
    rank runs the single-device path's fused tier (`ops/ils.py::
    fused_pass_for` and `fused_certify`: A2 on its tiles at worst-case
    stride, its envelopes reduced to per-(tile, window) scalars on its
    device), with one ``all_reduce`` gathering the violation flags,
    ``w_tiles`` and envelopes of every rank in rank order, so each rank
    certifies the same values and holds the same params.  Then each rank
    compacts its rows (A3) to its local row starts.  Only O(n_tiles *
    n_win) words cross between ranks.

    Retries with the "laggard" anchor where any rank's pass violated its
    emission band; raises ValueError, on every rank, for sections that need
    the two-pass single-device path, and `IlsVmemError` (a ValueError) where
    the certified cap exceeds the row budget."""
    on_mesh(mesh, data_dev, enc)
    tpd = tiles_per_device
    snum = ils_schedule_numer(avg_bits)
    stride_rows = stride_rows_for(k, max_len)
    e_band = fused_e_band(k)
    # the single-device path's tier gates, before any launch
    fused = fused_pass_for(k, stride_rows, e_band)
    if fused is None:
        raise ValueError(
            f"stride_rows={stride_rows} outside the fused certify+pack "
            "budget; this section needs the two-pass single-device path"
        )
    res = fused_certify(fused, data_dev, snum, enc, k=k,
                        stride_rows=stride_rows, e_band=e_band, rot=rot,
                        gather=lambda row: gather_shards(mesh, row[None]))
    if res is None:
        raise ValueError(
            "fused certify+pack violated its emission band at both anchors, "
            "or its certified w_cap exceeds the strided slack; this section "
            "needs the two-pass single-device path"
        )
    pay_s, params = res
    w_tiles = params.w_tiles.reshape(mesh.size, tpd).astype(np.int64)
    mine = w_tiles[mesh.rank]
    starts = np.zeros(tpd, np.int32)
    starts[1:] = np.cumsum(mine)[:-1]
    # every rank holds r_dev + w_cap rows: its own, then zeros (A3 zeroes
    # the rows after its tiles' as slack)
    r_dev = int(w_tiles.sum(axis=1).max()) + params.w_cap
    local_rows = int(mine.sum())
    with trace.span("ils.compact"):
        starts = trace.to_device(starts, mesh.device, "row_starts")
        payload = ils_compact(pay_s, starts, stride_rows=stride_rows,
                              w_cap=r_dev + params.w_cap - local_rows,
                              total_rows=local_rows)
    return IlsShardedSection(payload, starts, params)


class IlsShardedCodec:
    """`IlsCodec` over a mesh: one stream whose bytes lie on the ranks in
    rank order, each rank's a whole number of tiles of ``k``.

    Typical use, on every rank (each call is collective)::

        codec = IlsShardedCodec.fit(mesh, my_bytes)  # the global table
        shard = codec.encode(my_bytes)  # this rank's certified tiles
        whole = codec.decode(shard)     # the whole stream, on every rank
        blob = codec.container(shard)   # its ILS1 container, on every rank

    The table and ``k`` are those `IlsCodec.fit` gives the concatenated
    stream, and the shards' rows in rank order are `IlsCodec.encode`'s
    payload of it where that is one section (at most ``SECTION_BYTES``).
    Every rank's bytes must be as many, a multiple of ``k * 1024``."""

    def __init__(self, mesh: DataMesh, table: CodeTable, *, k: int,
                 rotate: bool | str = "auto"):
        self.mesh = mesh
        self.table = table
        with trace.span("ils.tables"):
            self.enc = ils_enc_tabs(table, device=mesh.device)
            self.dec = ils_dec_tabs(table, device=mesh.device)
        self.k = int(k)
        self.rotate = rotate if rotate == "auto" else bool(rotate)

    @classmethod
    def fit(cls, mesh: DataMesh, local_bytes, *,
            max_len: int = MAX_CODEWORD_LENGTH, k: int | None = None,
            optimize: str = "speed",
            rotate: bool | str = "auto") -> "IlsShardedCodec":
        """The table of the global histogram: this rank's counts summed
        over the ranks (one all-reduce), one zero byte added once for the
        padding, as `IlsCodec.fit` adds it to the concatenated stream."""
        freqs, _ = _global_counts(mesh,
                                  as_device_bytes(local_bytes, mesh.device))
        freqs[0] += 1
        return cls.from_counts(mesh, freqs, max_len=max_len, k=k,
                               optimize=optimize, rotate=rotate)

    @classmethod
    def from_counts(cls, mesh: DataMesh, freqs, *,
                    max_len: int = MAX_CODEWORD_LENGTH, k: int | None = None,
                    optimize: str = "speed",
                    rotate: bool | str = "auto") -> "IlsShardedCodec":
        """The codec of the optimal code of given global counts (the same
        on every rank), ``k`` by default as `pick_k` chooses it for the
        code's mean length over those counts."""
        freqs = np.asarray(freqs, np.int64)
        table = canonical_code_table(package_merge_lengths(freqs, max_len),
                                     max_len)
        avg = float((freqs * table.lengths.astype(np.int64)).sum()
                    / max(freqs.sum(), 1))
        return cls(mesh, table, k=k or pick_k(avg, optimize), rotate=rotate)

    def encode(self, local_bytes) -> IlsShardedSection:
        """This rank's bytes as its shard of one certified section.  The
        schedule's mean code length is the whole stream's (one all-reduce
        of the counts); ``rotate="auto"`` decides on the global band as
        `ops/ils.py::ils_encode_to_device` does.  Raises ValueError on
        every rank where the ranks' byte counts differ, or are not a
        positive multiple of ``k * 1024``."""
        mesh, k = self.mesh, self.k
        with trace.span("ils.shard_encode", device=mesh.device):
            data = as_device_bytes(local_bytes, mesh.device)
            tile_bytes = k * ILS_LANES
            tiles = data.numel() // tile_bytes
            freqs, (n_tiles, n_sq, bad) = _global_counts(
                mesh, data, (tiles, tiles * tiles,
                             int(data.numel() != tiles * tile_bytes)))
            # equal counts on every rank: the sum of the squares is then
            # the square of the sum over the ranks, and only then
            if bad or not n_tiles or n_tiles * n_tiles != mesh.size * n_sq:
                raise ValueError(
                    f"every rank must hold as many bytes, a positive multiple "
                    f"of k * 1024 = {tile_bytes}; rank {mesh.rank} holds "
                    f"{data.numel()}")
            avg_bits = float((freqs * self.table.lengths.astype(np.int64))
                             .sum() / freqs.sum())
            words = data.view(torch.int32).view(-1, ILS_LANES)
            kw = dict(k=k, max_len=max(self.table.max_len_present, 1),
                      avg_bits=avg_bits, tiles_per_device=tiles)
            if self.rotate != "auto":
                shard = ils_sharded_certified_encode(
                    mesh, words, self.enc, rot=self.rotate, **kw)
            else:
                shard = ils_sharded_certified_encode(
                    mesh, words, self.enc, rot=False, **kw)
                if shard.params.w_band > auto_rot_band(k):
                    rotated = ils_sharded_certified_encode(
                        mesh, words, self.enc, rot=True, **kw)
                    if rotated.params.w_band < shard.params.w_band:
                        shard = rotated
            trace.count("ils.sections")
            return shard

    def decode(self, shard: IlsShardedSection) -> torch.Tensor:
        """The whole stream, every rank's bytes in rank order, as a flat
        uint8 tensor on every rank: A1 on this rank's tiles, then the
        ordered gather."""
        mesh, p = self.mesh, shard.params
        with trace.span("ils.shard_decode", device=mesh.device):
            tpd = p.n_tiles // mesh.size
            with trace.span("ils.section", k=p.k, n_tiles=tpd):
                local = make_ils_sharded_decode(
                    mesh, k=p.k, w_cap=p.w_cap, w_band=p.w_band,
                    max_len=max(self.table.max_len_present, 1),
                    min_len=max(self.table.min_len, 1),
                    tiles_per_device=tpd, rot=p.rot,
                )(shard.payload_dev, shard.starts_dev, p.snum, None,
                  self.dec)
            with trace.span("ils.gather", device=mesh.device):
                whole = gather_shards(mesh, local)
            return whole.view(torch.uint8).reshape(-1)

    def container(self, shard: IlsShardedSection) -> bytes:
        """The ILS1 container of the whole stream, on every rank: one
        section a rank in rank order, each with its tiles' rows, row counts
        and band anchors and the global ``w_cap``, ``w_band`` and ``snum``.
        The rows come to every rank by the ordered gather of unequal
        shards."""
        mesh, p = self.mesh, shard.params
        tpd = p.n_tiles // mesh.size
        counts = p.w_tiles.astype(np.int64).reshape(mesh.size, tpd).sum(1)
        rows = gather_ragged(mesh, shard.payload_dev[: counts[mesh.rank]])
        ends = np.cumsum(counts)
        sections = []
        for r in range(mesh.size):
            tiles = slice(r * tpd, (r + 1) * tpd)
            sections.append(IlsSection(
                params=IlsParams(
                    k=p.k, snum=p.snum, boffs=p.boffs[tiles], w_band=p.w_band,
                    w_cap=p.w_cap, w_tiles=p.w_tiles[tiles], n_tiles=tpd,
                    rot=p.rot),
                payload=rows[ends[r] - counts[r]: ends[r]]))
        return write_ils_container(IlsCompressed(
            self.table, p.n_tiles * p.k * ILS_LANES, sections))


def _global_counts(mesh: DataMesh, data: torch.Tensor, extra=()):
    """This rank's (256,) byte counts, and the integers ``extra``, summed
    over the ranks in one int64 all-reduce; returns (the global counts, a
    list of the summed extras), both on the host."""
    with trace.span("ils.histogram", device=data.device):
        row = torch.empty(256 + len(extra), dtype=torch.int64,
                          device=data.device)
        row[:256] = byte_counts(data)
        for i, x in enumerate(extra):
            row[256 + i] = x
        all_reduce(mesh, row, "sum")
        row = trace.to_host(row, "histogram").numpy()
    trace.count("histogram_bytes", data.numel())
    return row[:256].copy(), [int(x) for x in row[256:]]


def make_ils_sharded_roundtrip(
    mesh: DataMesh,
    *,
    k: int,
    max_len: int,
    tiles_per_device: int,
    rot: bool = False,
):
    """The full step over the mesh: ILS pack (A5) -> decode (A1) ->
    bit-exact check, at full band with replicated tables.

    Returns fn(data (tiles_per_device * k//4, 1024) int32, enc, dec) ->
    (decoded, the rank's tiles, ok () int32), ``ok`` the MIN over the
    ranks of each rank's check, the same on every rank."""
    # worst-case even row count: always sufficient, full-band schedule
    w_cap = 2 * (_cdiv(k * max_len, 64) + 2)
    tpd = tiles_per_device

    def step(data_dev: torch.Tensor, enc: torch.Tensor, dec: IlsDecTabs):
        on_mesh(mesh, data_dev, enc, *dec)
        dev = data_dev.device
        boffs = torch.zeros((tpd, ils_n_win(k)), dtype=torch.int32, device=dev)
        starts = torch.arange(tpd, dtype=torch.int32, device=dev) * w_cap
        rows = ils_pack(data_dev, 0, boffs, starts, enc, k=k, w_cap=w_cap,
                        w_band=w_cap // 2, total_rows=tpd * w_cap, rot=rot)
        out = ils_decode(rows, starts, dec, k=k, w_cap=w_cap, n_tiles=tpd,
                         max_len=max_len, rot=rot)
        ok = (out == data_dev).all().to(torch.int32)
        return out, all_reduce(mesh, ok, "min")

    return step
