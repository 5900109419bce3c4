"""Interleaved-stream (ILS) layout constants and container parameters.

The layout contract is the JAX package's (`huffman_tpu/core/ils_ref.py`):

- A tile holds ``ILS_LANES = 1024`` streams and covers ``1024 * k`` bytes.
  Stream ``s`` owns the tile's u32 words ``{w : w % 1024 == s}``; symbol
  ``4i + j`` of the stream is byte ``j`` (little-endian) of its word ``i``.
- Each stream's codewords are packed MSB-first; payload row ``r`` of a tile
  holds word ``r`` of all 1024 streams.  Streams are zero-padded to the
  tile's even word count ``W_t`` (pairs of words are the transfer unit).
- Refill cadence v2, per body ``i`` of four symbols: the decoder refills a
  pair when ``valid <= 64`` (128-bit register, ``pptr`` starts at 2); the
  encoder emits a pair when ``used >= 64``, plus one final zero-padded
  pair.  ``mu_i = (i * snum) >> 16`` and the deviations of the refill
  pointer from it, per ``ILS_WIN``-body window, give the certified
  ``boffs``/``w_band`` stored in the container.
- With rotation on, stream ``(sub, lane)`` of body row ``r`` reads word
  ``((sub - r*ILS_ROT_SUB) % 8, (lane - r*ILS_ROT_LANE) % 128)``.

The NumPy oracle below (`ils_encode_np`, `ils_decode_np`, with
`ils_stream_symbols` and `ils_simulate_schedule`) is the JAX package's:
slow, exact, for inputs of a few tiles.  Its row-capacity buckets
(`_round_cap`) are the oracle's own, coarser than the device path's
(`ops/ils.py`), so its ``w_cap`` may differ from a container's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .canonical import CodeTable, build_flat_lut

__all__ = [
    "ILS_LANES",
    "ILS_WIN",
    "ILS_ROT_SUB",
    "ILS_ROT_LANE",
    "ils_n_win",
    "IlsParams",
    "ils_schedule_numer",
    "ils_stream_symbols",
    "ils_simulate_schedule",
    "ils_encode_np",
    "ils_decode_np",
]

ILS_LANES = 1024  # streams per tile
ILS_WIN = 64  # body iterations per band-anchor window
# lane-decorrelation rotation constants (container v4 format parameters)
ILS_ROT_SUB = 3
ILS_ROT_LANE = 5


def ils_n_win(k: int) -> int:
    return -(-(k // 4) // ILS_WIN)


@dataclasses.dataclass(frozen=True)
class IlsParams:
    """Per-section schedule/layout parameters stored in the container."""

    k: int  # symbols per stream (multiple of 4)
    snum: int  # expected word-PAIRS per body iteration, 16.16 fixed point
    boffs: np.ndarray  # (n_tiles, n_win) int32 windowed band anchors (pairs)
    w_band: int  # refill window width in PAIRS
    w_cap: int  # row capacity per tile in words (even, >= max W_t)
    w_tiles: np.ndarray  # (n_tiles,) int32 actual rows per tile (even)
    n_tiles: int
    rot: bool = False  # lane-decorrelation rotation (see ILS_ROT_*)

    @property
    def row_starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.w_tiles)]).astype(np.int32)

    @property
    def total_rows(self) -> int:
        return int(self.w_tiles.sum())


def ils_schedule_numer(avg_bits_per_symbol: float) -> int:
    """16.16 fixed-point expected word PAIRS consumed per body iteration
    (4 symbols, 64-bit pairs)."""
    return max(int(round(avg_bits_per_symbol * 4.0 / 64.0 * 65536.0)), 1)


def _rot_src_index(k: int, inverse: bool = False) -> np.ndarray:
    """(k//4, ILS_LANES) flat word index each stream reads per row (or, for
    ``inverse``, the flat stream index each word position reads back)."""
    r = np.arange(k // 4)[:, None, None]
    sub = np.arange(8)[None, :, None]
    lane = np.arange(ILS_LANES // 8)[None, None, :]
    sgn = 1 if inverse else -1
    src_sub = (sub + sgn * r * ILS_ROT_SUB) % 8
    src_lane = (lane + sgn * r * ILS_ROT_LANE) % (ILS_LANES // 8)
    return (src_sub * (ILS_LANES // 8) + src_lane).reshape(k // 4, ILS_LANES)


def ils_stream_symbols(data: np.ndarray, k: int, rot: bool = False) -> np.ndarray:
    """(n_tiles, k, LANES) uint8 symbol tensor from flat bytes.

    ``data.size`` must be a multiple of ``k * ILS_LANES``; symbol ``4r+j``
    of stream ``s`` in tile ``t`` is byte ``j`` (little-endian) of u32 word
    ``t*(k//4)*1024 + r*1024 + s``, or with ``rot`` of the torus-rotated
    word position."""
    data = np.asarray(data, np.uint8)
    if k % 4 or k <= 0:
        raise ValueError("k must be a positive multiple of 4")
    if data.size % (k * ILS_LANES):
        raise ValueError("data size must be a multiple of k * 1024")
    n_tiles = data.size // (k * ILS_LANES)
    u32 = data.reshape(n_tiles, k // 4, ILS_LANES, 4)
    if rot:
        src = _rot_src_index(k)
        u32 = np.take_along_axis(u32, src[None, :, :, None], axis=2)
    # (t, r, s, j) -> (t, 4r+j, s)
    return u32.transpose(0, 1, 3, 2).reshape(n_tiles, k, ILS_LANES)


def _mu(i, snum: int):
    """mu_i = (i * snum) >> 16 in 64 bits (as the kernels compute it)."""
    return (np.asarray(i, np.int64) * np.int64(snum)) >> 16


def ils_simulate_schedule(lens: np.ndarray, snum: int):
    """Simulate decoder refills and encoder emissions for every stream.

    Args:
      lens: (n_tiles, k, LANES) int codeword lengths (>= 1).
      snum: schedule numerator (pairs per iteration, 16.16 fixed point).

    Returns (bits_total (n_tiles, LANES) int64, dec_min, dec_max, enc_min,
    enc_max, each (n_tiles, n_win) int64): per-(tile, window) envelopes of
    the refill-read pairs and the emission-write pairs (flush included)
    relative to mu_i.
    """
    n_tiles, k, lanes = lens.shape
    assert k % 4 == 0
    n_win = ils_n_win(k)
    lens = lens.astype(np.int64)
    valid = np.full((n_tiles, lanes), 128, np.int64)
    pptr = np.full((n_tiles, lanes), 2, np.int64)
    used = np.zeros((n_tiles, lanes), np.int64)
    e_ptr = np.zeros((n_tiles, lanes), np.int64)
    big = np.int64(1 << 40)
    dec_min = np.full((n_tiles, n_win), big)
    dec_max = np.full((n_tiles, n_win), -big)
    enc_min = np.full((n_tiles, n_win), big)
    enc_max = np.full((n_tiles, n_win), -big)

    def track(mn, mx, w, mask, val, mu):
        d = np.where(mask, val - mu, big)
        np.minimum(mn[:, w], d.min(axis=1), out=mn[:, w])
        d = np.where(mask, val - mu, -big)
        np.maximum(mx[:, w], d.max(axis=1), out=mx[:, w])

    for i in range(k // 4):
        w = i // ILS_WIN
        mu = _mu(i, snum)
        l4 = lens[:, 4 * i : 4 * i + 4].sum(axis=1)
        valid = valid - l4
        used = used + l4
        refill = valid <= 64
        track(dec_min, dec_max, w, refill, pptr, mu)
        pptr = pptr + refill
        valid = valid + 64 * refill
        emit = used >= 64
        track(enc_min, enc_max, w, emit, e_ptr, mu)
        e_ptr = e_ptr + emit
        used = used - 64 * emit
    # final flush of a whole zero-padded pair, at the last iteration's mu
    mu = _mu(k // 4 - 1, snum)
    track(enc_min, enc_max, n_win - 1, used > 0, e_ptr, mu)
    bits = 64 * e_ptr + used
    return bits.astype(np.int64), dec_min, dec_max, enc_min, enc_max


def _round_band(span: int) -> int:
    for b in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512):
        if span <= b:
            return b
    return span


def _round_cap(rows: int) -> int:
    # the oracle's buckets, without the device path's 320/448/640
    for b in (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048):
        if rows <= b:
            return b
    return -(-rows // 256) * 256


def ils_encode_np(data: np.ndarray, table: CodeTable, k: int,
                  rot: bool = False):
    """Oracle ILS encoder.

    Returns (payload (total_rows, LANES) uint32, params: IlsParams).
    """
    syms = ils_stream_symbols(data, k, rot=rot)  # (T, k, L)
    n_tiles = syms.shape[0]
    lens = table.lengths[syms].astype(np.int64)
    if np.any(lens == 0):
        raise ValueError("input contains a symbol absent from the code table")
    codes = table.codes[syms].astype(np.uint64)

    avg = float(lens.mean())
    snum = ils_schedule_numer(avg)
    bits, dec_min, dec_max, _, _ = ils_simulate_schedule(lens, snum)

    # streams are padded to even word counts; tiles need >= 4 words so the
    # 128-bit register can initialize from rows 0..3
    w_tiles = np.maximum(2 * (-(-bits.max(axis=1) // 64)), 4).astype(np.int64)
    w_cap = _round_cap(int(w_tiles.max()))
    dec_span = int(np.maximum(dec_max - dec_min, 0).max(initial=0))
    w_band = _round_band(dec_span + 2)
    # the refill window must fit the tile's pair capacity: widen the cap
    # with zero rows rather than narrow the band below the envelope
    if 2 * w_band > w_cap:
        w_cap = _round_cap(2 * w_band)
    boffs = np.where(dec_min <= dec_max, dec_min, 0).astype(np.int32)
    assert boffs.shape == (n_tiles, ils_n_win(k))
    params = IlsParams(
        k=k,
        snum=snum,
        boffs=boffs,
        w_band=int(w_band),
        w_cap=int(w_cap),
        w_tiles=w_tiles.astype(np.int32),
        n_tiles=n_tiles,
        rot=rot,
    )

    row_starts = params.row_starts
    payload = np.zeros((params.total_rows, ILS_LANES), np.uint32)
    # per-stream bit offsets, then each codeword into one or two words
    ends = np.cumsum(lens, axis=1)
    offs = ends - lens  # (T, k, L) start bit within the stream
    left = (codes << (64 - lens).astype(np.uint64)).astype(np.uint64)
    sh = (offs % 32).astype(np.uint64)
    both = left >> sh
    hi = (both >> np.uint64(32)).astype(np.uint32)
    lo = (both & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    w0 = (offs // 32).astype(np.int64)  # stream-local word index
    t_idx, _, l_idx = np.meshgrid(
        np.arange(n_tiles), np.arange(k), np.arange(ILS_LANES), indexing="ij"
    )
    rows0 = row_starts[t_idx] + w0
    # every target word lies in its tile's rows; the spill word of the last
    # codeword may land on row W_t (zero bits only), and is dropped
    np.add.at(payload, (rows0.ravel(), l_idx.ravel()), hi.ravel())
    rows1 = rows0 + 1
    in_range = rows1 < row_starts[t_idx] + params.w_tiles[t_idx]
    np.add.at(
        payload,
        (rows1[in_range].ravel(), l_idx[in_range].ravel()),
        lo[in_range].ravel(),
    )
    return payload, params


def ils_decode_np(
    payload: np.ndarray, params: IlsParams, table: CodeTable
) -> np.ndarray:
    """Oracle ILS decoder: simulates the kernel's banded pair refills.

    Returns flat uint8 of n_tiles * k * LANES bytes.  Raises if a refill
    that matters falls outside the certified band (container invariant).
    """
    b = table.max_len_present
    lut_sym, lut_len = build_flat_lut(table, b)
    row_starts = params.row_starts
    k, lanes = params.k, ILS_LANES
    out = np.zeros((params.n_tiles, k, lanes), np.uint8)
    m32 = np.uint64(0xFFFFFFFF)
    cap_pairs = params.w_cap // 2
    lanes_i = np.arange(lanes)

    for t in range(params.n_tiles):
        rows = np.zeros((params.w_cap + 2, lanes), np.uint64)
        avail = min(params.w_cap, payload.shape[0] - row_starts[t])
        rows[:avail] = payload[row_starts[t] : row_starts[t] + avail]
        a = [rows[j].copy() for j in range(4)]  # 128-bit register, MSB-first
        valid = np.full(lanes, 128, np.int64)
        pptr = np.full(lanes, 2, np.int64)
        for i in range(k // 4):
            boff = int(params.boffs[t, i // ILS_WIN])
            base = int(min(max(_mu(i, params.snum) + boff, 0),
                           cap_pairs - params.w_band))
            for j in range(4):
                s = 4 * i + j
                idx = (a[0] >> np.uint64(32 - b)).astype(np.int64)
                out[t, s] = lut_sym[idx]
                ln = lut_len[idx].astype(np.uint64)
                for w in range(3):
                    a[w] = ((a[w] << ln) | (a[w + 1] >> (np.uint64(32) - ln))) & m32
                a[3] = (a[3] << ln) & m32
                valid = valid - ln.astype(np.int64)
            # banded pair refill
            need = valid <= 64
            rel = pptr - base
            in_band = (rel >= 0) & (rel < params.w_band)
            sel = np.where(in_band, np.clip(rel, 0, params.w_band - 1), 0)
            w0 = np.where(in_band, rows[2 * (base + sel), lanes_i], 0)
            w1 = np.where(in_band, rows[2 * (base + sel) + 1, lanes_i], 0)
            # the certified schedule puts every refill in band except the
            # trailing loads past the tile's pair capacity, whose bits are
            # never consumed
            if np.any(need & ~in_band & (pptr < cap_pairs)):
                raise ValueError("refill outside certified band")
            w0 = np.where(need, w0, 0)
            w1 = np.where(need, w1, 0)
            # insert 64 bits at offset `valid` of the 128-bit register
            r = (valid & 31).astype(np.uint64)
            j0 = (valid >> 5).astype(np.int64)  # word holding bit `valid`
            hi0 = w0 >> r
            lo0 = ((w0 << np.uint64(1)) << (np.uint64(31) - r)) & m32
            hi1 = w1 >> r
            lo1 = ((w1 << np.uint64(1)) << (np.uint64(31) - r)) & m32
            for w in range(4):
                a[w] = a[w] | np.where(j0 == w, hi0, 0)
                a[w] = a[w] | np.where(j0 + 1 == w, lo0 | hi1, 0)
                a[w] = a[w] | np.where(j0 + 2 == w, lo1, 0)
            pptr = pptr + need
            valid = valid + 64 * need
    # (t, 4r+j, s) -> bytes of u32 words, the lane rotation inverted so
    # the decoded output is the original data
    n_tiles = params.n_tiles
    dec = out.reshape(n_tiles, k // 4, 4, lanes)
    if params.rot:
        src = _rot_src_index(k, inverse=True)
        dec = np.take_along_axis(dec, src[None, :, None, :], axis=3)
    u32view = dec.transpose(0, 1, 3, 2)
    return np.ascontiguousarray(u32view).reshape(-1)
