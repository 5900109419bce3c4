"""Device orchestration for the interleaved-stream (ILS) codec.

Counterpart of `huffman_tpu/ops/ils.py`.  Encode is the fused certify+pack
pass plus a compaction, escalating from the "mu" to the "laggard" window
anchor and falling to the certified two-pass pipeline (schedule pass, then
pack) exactly where the JAX package does; decode is one kernel launch whose
int32 output is the original data.

The host policy below (`pick_k`, the band and cap buckets, `certify_params`,
`fused_e_band`, `auto_rot_band`, the budgets and the tier order) is kept
VERBATIM from the JAX package.  It was named for the TPU's VMEM, but it
decides ``k``, ``w_band``, ``w_cap`` and ``rot``, which are written into the
container: here it is format policy, and changing it changes the bytes.
The two-pass tier is part of that policy, not a device fallback.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.canonical import CodeTable
from ..core.ils_ref import ILS_LANES, IlsParams, ils_n_win, ils_schedule_numer
from ..utils import trace
from .ils_kernels import (
    CHUNK_I,
    FUSED_E_BAND,
    IlsDecTabs,
    ils_compact,
    ils_decode,
    ils_lengths_pass,
    ils_pack,
    ils_pack_certify,
    ils_pack_certify_stream,
    ils_stream_span_rows,
    resolve_device,
)

__all__ = [
    "IlsSection",
    "IlsVmemError",
    "certify_params",
    "ils_encode_to_device",
    "ils_encode_device",
    "ils_decode_device",
    "pick_k",
    "round_band",
    "round_cap",
    "resolve_device",
    "stride_rows_for",
    "envelope_params",
    "tile_meta",
    "meta_params",
    "fused_pass_for",
    "fused_certify",
    "emission_band",
    "row_starts_of",
]

# ROADMAP.md trap F1: these are the device path's buckets (ops/ils.py in
# the JAX package), which the container holds; the NumPy oracle's w_cap
# rounding lacks 320/448/640/... and must not be copied.
_BAND_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)
_CAP_BUCKETS = (
    8, 16, 32, 64, 96, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896,
    1024, 1280, 1536, 1792, 2048,
)

# Format policy kept verbatim (see the module docstring): the row budget
# that bounds w_cap before k halves, the smallest k, and the worst-case
# stride above which the two-pass pipeline encodes.
VMEM_ROW_BUDGET = 2800
MIN_K = 2048
FUSED_STRIDE_BUDGET = 2048

# The streaming fused pack (TPU kernel D1, `ils_pack_certify_stream`) may
# encode a section whose stride is over the budget while its sliding span
# is under it.  Off by default, as in the JAX package.  Its payload is the
# two-pass tier's, but it certifies w_cap from the decode envelope alone,
# where the two-pass tier also fits the emission band (trap F2): the two
# can write different w_cap, and so different container bytes, where that
# band is the wider.  On 2 tiles of k=8192 at r=0.5 both wrote the same
# bytes on an H100 (chip_smoke.py phase 11 logs the comparison).
PREFER_STREAM_PACK = False
# bodies per grid chunk of the streaming pack; it sets that pack's flush
# cadence (`flush_group`) and its span
_STREAM_CHUNK_CAP = CHUNK_I


def fused_e_band(k: int) -> int:
    """Emission-band width (pairs) for the fused certify+pack pass; grows
    ~sqrt(k) from 32 pairs at k=4096."""
    return max(FUSED_E_BAND, round_band(int(32 * (k / 4096) ** 0.5)))


def auto_rot_band(k: int) -> int:
    """rot="auto": bands at or under this many pairs never re-encode with
    rotation; same ~sqrt(k) scale from 32 pairs at k=4096."""
    return max(round_band(int(32 * (k / 4096) ** 0.5)), 8)


class IlsVmemError(ValueError):
    """Tile shape would exceed the row budget; retry with a smaller k."""


def pick_k(avg_bits: float, optimize: str = "speed") -> int:
    """Choose k (symbols per stream) for the table's mean code length:
    ``optimize="speed"`` caps k at 4096, ``"ratio"`` allows up to 16384
    while the estimated rows fit the budget."""
    max_k = 4096 if optimize == "speed" else 16384
    best = 2048
    for k in (2048, 4096, 8192, 16384):
        if k > max_k:
            break
        w_est = round_cap(int(k * max(avg_bits, 1.0) / 32 * 1.10) + 8)
        if w_est <= VMEM_ROW_BUDGET:
            best = k
    return best


def round_band(span: int) -> int:
    for b in _BAND_BUCKETS:
        if span <= b:
            return b
    return span


def round_cap(rows: int) -> int:
    for b in _CAP_BUCKETS:
        if rows <= b:
            return b
    return -(-rows // 256) * 256


def certify_params(
    *,
    k: int,
    snum: int,
    n_tiles: int,
    w_tiles: np.ndarray,
    dec_min: np.ndarray,
    dec_max: np.ndarray,
    extra_band_pairs: int = 0,
    rot: bool = False,
) -> IlsParams:
    """Turn measured schedule envelopes into certified container params.

    The refill window must fit the tile's pair capacity (``band <= w_cap //
    2``); when the envelope needs more, w_cap is WIDENED with zero slack
    rows rather than the band narrowed.  Raises ``IlsVmemError`` when even
    the widened cap exceeds the row budget (the codec retries a smaller k).
    """
    w_cap = round_cap(int(w_tiles.max()))
    dec_span = int(np.maximum(dec_max - dec_min, 0).max(initial=0))
    w_band = round_band(dec_span + 2)  # in pairs
    need_cap = 2 * max(w_band, extra_band_pairs)
    if need_cap > w_cap:
        w_cap = round_cap(need_cap)
    if w_cap > VMEM_ROW_BUDGET and k > MIN_K:
        raise IlsVmemError(
            f"k={k} with w_cap={w_cap} exceeds the VMEM row budget; "
            "re-encode with a smaller k"
        )
    assert w_band <= w_cap // 2  # guaranteed by the widening above
    # int32 envelopes with +-2^30 sentinels; an empty window keeps 0
    boffs = np.where(dec_min <= dec_max, dec_min, 0).astype(np.int32)
    return IlsParams(
        k=k, snum=snum, boffs=boffs, w_band=int(w_band),
        w_cap=int(w_cap), w_tiles=w_tiles.astype(np.int32),
        n_tiles=n_tiles, rot=rot,
    )


@dataclasses.dataclass
class IlsSection:
    """One uniform-k run of tiles plus its interleaved payload."""

    params: IlsParams
    payload: torch.Tensor  # (total_rows, 1024) int32, the u32 words' bits

    @property
    def nbytes_payload(self) -> int:
        return int(self.payload.numel() * 4)

    def payload_u32(self) -> np.ndarray:
        """The payload on the host as (total_rows, 1024) uint32."""
        return trace.to_host(self.payload, "payload_u32").numpy().view(np.uint32)


def _as_tiles_i32(data: torch.Tensor) -> torch.Tensor:
    """Flat uint8 bytes (multiple of 4 KB) -> (rows, 1024) int32 words,
    little-endian, zero-copy."""
    return data.view(torch.int32).view(-1, ILS_LANES)


def _lane_min(x: torch.Tensor) -> np.ndarray:
    return trace.to_host(x.amin(dim=-1), "lane_min").numpy()


def _lane_max(x: torch.Tensor) -> np.ndarray:
    return trace.to_host(x.amax(dim=-1), "lane_max").numpy()


def stride_rows_for(k: int, max_len: int) -> int:
    """Worst-case rows per tile (every symbol at max_len): the fused pack's
    tile stride, which no tile's ``w_tiles`` can exceed."""
    return max(2 * (-(-k * max_len // 64)), 4)


def tile_meta(bits, dn, dx, viol=None) -> torch.Tensor:
    """A pass's outputs reduced on the device to one int32 row: [violated,
    w_tiles (n_tiles), dec_min (n_tiles * n_win), dec_max (n_tiles *
    n_win)], the only metadata that certification reads."""
    # even word counts (pair granularity), >= 4 for the 128-bit register
    # init; envelopes reduce over lanes
    w_tiles = torch.clamp(2 * (-(-bits.amax(dim=1) // 64)), min=4)
    violated = (torch.zeros(1, dtype=torch.int32, device=bits.device)
                if viol is None else viol.amax().reshape(1))
    return torch.cat([violated.to(torch.int32), w_tiles.to(torch.int32),
                      dn.amin(dim=-1).reshape(-1).to(torch.int32),
                      dx.amax(dim=-1).reshape(-1).to(torch.int32)])


def meta_params(meta: np.ndarray, *, k: int, snum: int, rot: bool,
                extra_band_pairs: int = 0) -> IlsParams:
    """Certified params from the `tile_meta` rows of D devices, (D, L) in
    device order, each device's tiles after the one before's."""
    n_win = ils_n_win(k)
    n_dev = meta.shape[0]
    tpd = (meta.shape[1] - 1) // (1 + 2 * n_win)
    env = meta[:, 1 + tpd:].reshape(n_dev, 2, tpd * n_win)
    return certify_params(
        k=k, snum=snum, n_tiles=n_dev * tpd,
        w_tiles=meta[:, 1: 1 + tpd].reshape(-1).astype(np.int64),
        dec_min=env[:, 0].reshape(-1, n_win),
        dec_max=env[:, 1].reshape(-1, n_win),
        extra_band_pairs=extra_band_pairs, rot=rot,
    )


def envelope_params(bits, dn, dx, *, k: int, snum: int, rot: bool,
                    extra_band_pairs: int = 0) -> IlsParams:
    """Certified params from a pass's per-stream bits and decode envelopes
    (`ils_pack_certify` or `ils_lengths_pass` outputs)."""
    meta = trace.to_host(tile_meta(bits, dn, dx)[None], "envelope").numpy()
    return meta_params(meta, k=k, snum=snum, rot=rot,
                       extra_band_pairs=extra_band_pairs)


def fused_pass_for(k: int, stride_rows: int, e_band: int,
                   stride_budget: int = FUSED_STRIDE_BUDGET):
    """The fused certify+pack tier's pass for this stride, or None where
    the section takes the two-pass tier.

    As the JAX package: stride_rows < 8 can never pass the compact gate of
    `fused_certify` (the certified cap is at least 16), so tiny tail
    sections go straight to two-pass.  A stride over the budget takes the
    streaming pack when PREFER_STREAM_PACK is on and its span is within
    the same budget, else two-pass."""
    if stride_rows < 8:
        return None
    if stride_rows <= stride_budget:
        return ils_pack_certify
    if PREFER_STREAM_PACK:
        span = ils_stream_span_rows(k, stride_rows, e_band,
                                    chunk_cap=_STREAM_CHUNK_CAP)
        if span is not None and span <= stride_budget:
            return functools.partial(ils_pack_certify_stream,
                                     chunk_cap=_STREAM_CHUNK_CAP)
    return None


def fused_certify(fused, data_i32, snum: int, enc, *, k: int,
                  stride_rows: int, e_band: int, rot: bool, gather=None):
    """The fused tier's certification: ``fused`` (`fused_pass_for`) at
    the "mu", then at the "laggard" window anchor, its outputs reduced to
    one `tile_meta` row and certified.  ``gather`` maps this device's row
    to the (D, L) rows of all devices in order (the sharded encode's
    collective; by default this device alone), so every device decides on
    the same values.  Returns (strided payload, params), or None where the
    section needs the two-pass tier: the pass violated its emission band
    at both anchors, or the envelope-widened cap exceeds the strided
    slack."""
    for anchor in ("mu", "laggard"):
        with trace.span("ils.pass", tier="fused", anchor=anchor, rot=rot):
            trace.count("ils.passes")
            pay_s, bits, dn, dx, viol = fused(
                data_i32, snum, enc, k=k, stride_rows=stride_rows,
                e_band=e_band, rot=rot, anchor=anchor,
            )
            row = tile_meta(bits, dn, dx, viol)
            meta = trace.to_host(row[None] if gather is None else gather(row),
                                 "certify").numpy()
        if meta[:, 0].any():
            continue
        params = meta_params(meta, k=k, snum=snum, rot=rot)
        # the compaction may read up to w_cap rows of the last tile's
        # region; an envelope-widened cap beyond 2*stride_rows takes the
        # two-pass tier (anchor-independent, so no retry)
        if params.w_cap > 2 * stride_rows:
            return None
        return pay_s, params
    return None


def emission_band(en, ex) -> tuple[int, np.ndarray]:
    """The two-pass tier's emission band (pairs) and its (n_tiles, n_win)
    int32 window anchors, from `ils_lengths_pass`'s emission envelopes."""
    enc_min, enc_max = _lane_min(en), _lane_max(ex)
    enc_span = int(np.maximum(enc_max - enc_min, 0).max(initial=0))
    boffs = np.where(enc_min <= enc_max, enc_min, 0).astype(np.int32)
    return round_band(enc_span + 2), boffs


def row_starts_of(params: IlsParams, dev) -> torch.Tensor:
    """(n_tiles,) int32 compact row offsets on ``dev``.

    The kernels take these on trust (checking them there would cost a
    device-to-host sync per launch): they are the prefix sum of ``w_tiles``,
    each at most the worst-case stride.  Rows a kernel would address outside
    its buffers are skipped or read as zero there."""
    return trace.to_device(params.row_starts[:-1].astype(np.int32), dev,
                           "row_starts")


def ils_encode_to_device(
    data_i32: torch.Tensor,
    enc: torch.Tensor,
    *,
    k: int,
    avg_bits: float,
    max_len: int | None = None,
    rot: bool | str = False,
    e_band: int | None = None,
    stride_budget: int = FUSED_STRIDE_BUDGET,
):
    """Device-resident encode: returns (payload_rows, row_starts, params).

    payload_rows stays where ``data_i32`` lies ((total_rows + w_cap, 1024)
    int32, compacted, with w_cap zero slack rows); only per-tile metadata
    comes to the host.  ``stride_budget`` is the worst-case stride above
    which the two-pass pipeline runs (default FUSED_STRIDE_BUDGET; 0 forces
    two-pass), or the streaming pack where `PREFER_STREAM_PACK` is on.
    ``e_band`` overrides `fused_e_band(k)`, the fused pass's emission band;
    it exists to drive the anchor escalation in checks and is not part of
    `ils_encode_device`.  Both change which tier runs, and so possibly
    w_cap.

    ``rot="auto"``: encode unrotated; if the certified band exceeds
    `auto_rot_band(k)`, re-encode rotated and keep whichever band is
    strictly narrower.
    """
    if rot == "auto":
        kw = dict(k=k, avg_bits=avg_bits, max_len=max_len, e_band=e_band,
                  stride_budget=stride_budget)
        res_plain = ils_encode_to_device(data_i32, enc, rot=False, **kw)
        if res_plain[2].w_band <= auto_rot_band(k):
            return res_plain
        res_rot = ils_encode_to_device(data_i32, enc, rot=True, **kw)
        return res_rot if res_rot[2].w_band < res_plain[2].w_band else res_plain

    rot = bool(rot)
    dev = data_i32.device
    snum = ils_schedule_numer(avg_bits)
    e_band = fused_e_band(k) if e_band is None else e_band
    if max_len is None:
        max_len = int(trace.to_host((enc >> 20).max(), "max_len"))
    stride_rows = stride_rows_for(k, max_len)
    fused = fused_pass_for(k, stride_rows, e_band, stride_budget)
    res = None if fused is None else fused_certify(
        fused, data_i32, snum, enc, k=k, stride_rows=stride_rows,
        e_band=e_band, rot=rot)
    if res is not None:
        pay_s, params = res
        with trace.span("ils.compact"):
            row_starts = row_starts_of(params, dev)
            payload_rows = ils_compact(
                pay_s, row_starts, stride_rows=stride_rows,
                w_cap=params.w_cap, total_rows=params.total_rows,
            )
        return payload_rows, row_starts, params

    with trace.span("ils.pass", tier="two_pass", anchor=None, rot=rot):
        trace.count("ils.passes")
        # A5 takes A4's chunk bits rather than counting them again
        bits, dn, dx, en, ex, cbits = ils_lengths_pass(
            data_i32, snum, enc, k=k, rot=rot, chunk_bits=True)
        w_band_enc, boffs_enc = emission_band(en, ex)
        # the emission window needs w_band_enc <= w_cap // 2 as well; this
        # extra band is why the two-pass tier can write a wider w_cap
        # (ROADMAP.md trap F2)
        params = envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                                 extra_band_pairs=w_band_enc)
        row_starts = row_starts_of(params, dev)
        payload_rows = ils_pack(
            data_i32, snum, trace.to_device(boffs_enc, dev, "boffs"),
            row_starts, enc, k=k, w_cap=params.w_cap, w_band=w_band_enc,
            total_rows=params.total_rows, rot=rot, cbits=cbits,
        )
    return payload_rows, row_starts, params


def _as_bytes(data, dev: torch.device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise TypeError(f"data must be uint8, got {data.dtype}")
        return trace.to_device(data.reshape(-1), dev, "input").contiguous()
    arr = np.ascontiguousarray(np.asarray(data, np.uint8).reshape(-1))
    return trace.to_device(arr, dev, "input")


def ils_encode_device(
    data,
    table: CodeTable,
    enc: torch.Tensor,
    *,
    k: int,
    avg_bits: float,
    rot: bool | str = False,
    device="cuda",
    stride_budget: int = FUSED_STRIDE_BUDGET,
) -> IlsSection:
    """Encode flat bytes (a uint8 array or tensor whose size is a multiple
    of k*1024) into one section on ``device``; the payload stays there.
    ``stride_budget=0`` forces the two-pass tier (see
    `ils_encode_to_device`)."""
    dev = resolve_device(device)
    data = _as_bytes(data, dev)
    if data.numel() % (k * ILS_LANES):
        raise ValueError("data size must be a multiple of k * 1024")
    payload_rows, _, params = ils_encode_to_device(
        _as_tiles_i32(data), enc.to(dev), k=k, avg_bits=avg_bits,
        max_len=int(table.max_len_present), rot=rot,
        stride_budget=stride_budget,
    )
    return IlsSection(params=params, payload=payload_rows[: params.total_rows])


def ils_decode_device(
    section: IlsSection,
    table: CodeTable,
    dec: IlsDecTabs,
    *,
    probe: bool | None = None,
    device="cuda",
) -> torch.Tensor:
    """Decode one section back to flat uint8 bytes (n_tiles * k * 1024 of
    them) on ``device``.  ``probe`` (the JAX package's choice of a TPU
    symbol step) is accepted and changes nothing: the kernel always takes
    lengths from its table."""
    dev = resolve_device(device)
    p = section.params
    if not (1 <= p.w_band <= p.w_cap // 2):
        # our encoder guarantees this (finish() widens w_cap); a foreign or
        # corrupted container must not reach the kernel
        raise ValueError(
            f"invalid ILS section: w_band={p.w_band} outside "
            f"[1, w_cap//2={p.w_cap // 2}]"
        )
    rows = trace.to_device(section.payload, dev, "payload")
    if tuple(rows.shape) != (p.total_rows, ILS_LANES):
        raise ValueError(
            f"ILS section payload has shape {tuple(rows.shape)}, expected "
            f"({p.total_rows}, {ILS_LANES})"
        )
    # no slack rows are appended: the decoder reads rows past the payload's
    # end as zeros
    out = ils_decode(
        rows.contiguous(), row_starts_of(p, dev),
        IlsDecTabs(*(trace.to_device(x, dev, "dec_tables") for x in dec)),
        k=p.k, w_cap=p.w_cap, n_tiles=p.n_tiles,
        max_len=max(table.max_len_present, 1),
        min_len=max(table.min_len, 1), rot=p.rot,
    )
    return out.view(torch.uint8).reshape(-1)
