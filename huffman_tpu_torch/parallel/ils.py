"""Sharded interleaved-stream (ILS) codec: the tile axis over the ranks.

Counterpart of `huffman_tpu/parallel/ils.py`.  Tiles are independent given
the replicated code table, so each rank encodes and decodes its contiguous
range of ``tiles_per_device`` tiles with the port's kernels (A2 and A3 for
the certified encode, A5 for the full-band pack, A1 for every decode) on
its own device.  Each function takes and returns the rank's local shard in
the flat lane layout ``(rows, 1024)`` int32; `mesh.gather_shards` gives
the rank-ordered whole.

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

from .mesh import DataMesh, all_reduce, gather_shards, on_mesh
from ..core.ils_ref import ILS_LANES, IlsParams, ils_n_win, ils_schedule_numer
from ..ops.ils import (
    fused_certify,
    fused_e_band,
    fused_pass_for,
    stride_rows_for,
)
from ..ops.ils_kernels import IlsDecTabs, ils_compact, ils_decode, ils_pack

__all__ = [
    "shard_ils_payload",
    "make_ils_sharded_decode",
    "make_ils_sharded_roundtrip",
    "ils_sharded_certified_encode",
    "IlsShardedSection",
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
    starts = torch.from_numpy(starts).to(mesh.device)
    # every rank holds r_dev + w_cap rows: its own, then zeros (A3 zeroes
    # the rows after its tiles' as slack)
    r_dev = int(w_tiles.sum(axis=1).max()) + params.w_cap
    local_rows = int(mine.sum())
    payload = ils_compact(pay_s, starts, stride_rows=stride_rows,
                          w_cap=r_dev + params.w_cap - local_rows,
                          total_rows=local_rows)
    return IlsShardedSection(payload, starts, params)


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
