"""ILS kernels A1-A5: wrappers, plain PyTorch versions and launch counters.

Counterpart of `huffman_tpu/ops/pallas/ils_kernels.py`.  Each wrapper
takes tensors in the flat lane layout ``(rows, 1024)`` (the JAX package's
``(rows, 8, 128)`` reshaped) and routes on the device of its main tensor:

- a CUDA tensor launches the hand-written kernel in ``csrc/`` (built at
  first use, `cuda_build.py`) or raises; there is no fallback;
- a CPU tensor runs the plain PyTorch version, which repeats the kernel's
  arithmetic body by body on tensors of all streams at once.

The plain versions also run on CUDA tensors when called directly: that is
how a kernel is held against them on the card.  They keep u32 values in
int64 masked to 32 bits, since torch's ``>>`` on int32 is arithmetic.

Each wrapper counts its kernel launches in the port's counter store
(`utils/trace.py`, ``launches.<wrapper>``); `reset_launch_counts` and
`launch_counts` read them together.  The TPU kernels' banded one-hot
refill and emission windows, lane tables, rolls and chunked grids are TPU
artifacts and are not carried over; where a window decided TPU output
(the dropped out-of-band pairs and the violation flag, ROADMAP.md trap
F2) the cadence is replayed exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.canonical import CodeTable
from ..core.ils_ref import ILS_LANES, ILS_WIN, _rot_src_index, ils_n_win
from ..utils import trace

__all__ = [
    "IlsDecTabs",
    "ils_enc_tabs",
    "ils_dec_tabs",
    "resolve_device",
    "ils_lengths_pass",
    "ils_pack_certify",
    "ils_pack_certify_stream",
    "ils_stream_span_rows",
    "ils_pack",
    "ils_compact",
    "ils_decode",
    "ils_decode_lut",
    "ils_lengths_pass_plain",
    "ils_chunk_bits_plain",
    "ils_pack_certify_plain",
    "ils_pack_certify_stream_plain",
    "certify_chunks",
    "ils_pack_plain",
    "ils_compact_plain",
    "ils_decode_plain",
    "reset_launch_counts",
    "launch_counts",
    "flush_group",
    "FUSED_E_BAND",
]

# Bodies per grid chunk of the TPU kernels.  Only its parity matters here:
# it fixes the TPU pack kernels' flush cadence (`flush_group`), and with it
# the violation flag and the container bytes.
CHUNK_I = 512

# Emission band guess (pairs) of the fused path; the flag, not the
# estimate, carries correctness.
FUSED_E_BAND = 32

_BIG = 1 << 30  # int32 envelope sentinels (+-2^30), as the JAX kernels
_M32 = 0xFFFFFFFF

# Windows (of ILS_WIN bodies) in each chunk of A2's streams (`certify_chunks`)
CERTIFY_CHUNK_WIN = 4

# Window bits of A1's length-and-symbol table (2 ** ILS_LUT_BITS u16
# entries in shared memory, built by each block; `ils_decode_lut`); 10 and
# 12 measured the same on an H100
ILS_LUT_BITS = 11


def _chunk_iters(k, cap=CHUNK_I):
    """Bodies per TPU grid chunk: the largest divisor of k//4 <= cap."""
    kq = k // 4
    if kq <= cap:
        return kq
    for it in range(cap, 0, -1):
        if kq % it == 0:
            return it
    return 1


def flush_group(k: int, w_band: int, chunk_cap: int = CHUNK_I) -> int:
    """Bodies per flush of the TPU pack kernels (ROADMAP.md trap F2: the
    cadence decides the dropped out-of-band pairs and the violation flag,
    and so the tier and the container bytes).

    The TPU kernels flush every ``G = 2`` bodies when their unroll factor is
    even, else every body.  The unroll is the largest of 16/8/4/2 that
    divides the bodies per grid chunk, `_chunk_iters(k, chunk_cap)`, under a
    cap set by the band (1 above 192 pairs, at least 2 otherwise), so it is
    even exactly when the chunk is even and the band is at most 192 pairs.
    The streaming pack (D1) chunks by its own ``chunk_cap``, so its cadence
    can differ from the other kernels' at the same k."""
    return 2 if _chunk_iters(k, chunk_cap) % 2 == 0 and w_band <= 192 else 1


# ----------------------------------------------------------------------
# Tables
# ----------------------------------------------------------------------
class IlsDecTabs(NamedTuple):
    """Decoder tables: canonical limits, rank bias and the rank->symbol map."""

    lim: torch.Tensor  # (32,) int32 bit patterns of the u32 left-justified limits
    bias: torch.Tensor  # (32,) int32 offsets[l] - first_code[l]
    symtab: torch.Tensor  # (256,) int32 canonical rank -> symbol


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.

    A CUDA device without a usable card raises here rather than running the
    plain versions quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "huffman_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def ils_enc_tabs(table: CodeTable, *, device="cuda") -> torch.Tensor:
    """(256,) int32 ``(len << 20) | code`` per symbol, on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    packed = (table.lengths.astype(np.int32) << 20) | table.codes.astype(np.int32)
    with trace.span("ils.enc_tables"):
        return trace.to_device(packed.astype(np.int32), resolve_device(device),
                               "enc_table")


def ils_dec_tabs(table: CodeTable, *, device="cuda") -> IlsDecTabs:
    """The decoder's tables of ``table`` on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    lim = np.zeros(32, np.uint32)
    lim[: table.lim_left.shape[0]] = table.lim_left
    bias = np.zeros(32, np.int32)
    b = table.offsets.astype(np.int64) - table.first_code.astype(np.int64)
    bias[: b.shape[0]] = b.astype(np.int32)
    symtab = np.zeros(256, np.int32)
    symtab[: table.num_symbols] = table.symtab
    with trace.span("ils.dec_tables"):
        return IlsDecTabs(
            trace.to_device(lim.view(np.int32), device, "dec_tables"),
            trace.to_device(bias, device, "dec_tables"),
            trace.to_device(symtab, device, "dec_tables"),
        )


# ----------------------------------------------------------------------
# Routing, launch counts and checks
# ----------------------------------------------------------------------
def _use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the kernels run on CUDA or CPU tensors, not {x.device}")


def _check(name, x, dtype, shape=None):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(ref, *xs):
    for x in xs:
        if x.device != ref.device:
            raise ValueError(f"tensors on {ref.device} and {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launched(fn, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed (cudaError {rc})")
    trace.count(trace.LAUNCH + fn.__name__)


def _lib(name: str):
    from .cuda_build import load_kernels

    return load_kernels()[name]


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bits as int32."""
    x = x & _M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _rot_src(k: int, device) -> torch.Tensor:
    return torch.from_numpy(_rot_src_index(k)).to(device)


# ----------------------------------------------------------------------
# Encoder step (A2, A4, A5): plain version
# ----------------------------------------------------------------------
def _encode_plain(data_i32, enc, *, k, snum, rot, pack, certify, compact_dst,
                  n_out_rows=0, row0=None, G=1, W=0, cap_pairs=0, boff_est=0,
                  laggard=False, boffs=None):
    """The per-stream encoder step of ``csrc/ils_encode.cu``, all streams
    at once.  Returns (payload int64 or None, bits, dn, dx, en, ex, viol)."""
    dev = data_i32.device
    nb = k // 4
    n_tiles = data_i32.shape[0] // nb
    n_win = ils_n_win(k)
    sim_dec = not compact_dst
    x = _u32(data_i32).view(n_tiles, nb, ILS_LANES)
    tab = enc.to(torch.int64)
    src = _rot_src(k, dev) if rot else None
    shape = (n_tiles, ILS_LANES)
    zeros = torch.zeros(shape, dtype=torch.int64, device=dev)
    lanes = torch.arange(ILS_LANES, device=dev)[None, :].expand(shape)
    a = [zeros.clone() for _ in range(4)]  # 128-bit MSB-first accumulator
    used, e_ptr = zeros.clone(), zeros.clone()
    valid, pptr = zeros + 128, zeros + 2
    viol = torch.zeros(shape, dtype=torch.bool, device=dev)
    big = torch.full((n_tiles, n_win, ILS_LANES), _BIG, dtype=torch.int64,
                     device=dev)
    dn, dx, en, ex = big.clone(), -big, big.clone(), -big
    base_hi = cap_pairs - W
    # one spare row past the payload takes the writes of masked lanes
    pay = None
    if pack:
        pay = torch.zeros(n_out_rows + 1, ILS_LANES, dtype=torch.int64,
                          device=dev)
        row0 = row0.to(torch.int64).view(n_tiles, 1)
    base = 0  # laggard: the tile minimum of e_ptr after the previous flush

    def emit_pair(emit, base):
        nonlocal viol
        rel = e_ptr - base
        inband = (rel >= 0) & (rel < W)
        if certify:
            viol = viol | (emit & ~inband)
        # a pair the buffer cannot hold (untrusted row starts) is skipped,
        # as in the kernel
        dst = row0 + 2 * e_ptr
        ok = emit & inband & (dst >= 0) & (dst + 1 < n_out_rows)
        pay[torch.where(ok, dst, n_out_rows), lanes] = a[0]
        pay[torch.where(ok, dst + 1, n_out_rows), lanes] = a[1]

    def window_base(i, wi):
        mu_i = (i * snum) >> 16
        if compact_dst:
            boff = boffs[:, wi : wi + 1].to(torch.int64)
            return torch.clamp(mu_i + boff, 0, base_hi)
        return min(max(mu_i + boff_est, 0), base_hi)

    for i in range(nb):
        mu = (i * snum) >> 16
        wi = i // ILS_WIN
        if pack and not laggard and i % G == 0:
            base = window_base(i, wi)
        w = x[:, i, :] if src is None else x[:, i, src[i]]
        l4 = zeros
        for j in range(4):
            e = tab[(w >> (8 * j)) & 255]
            ln = e >> 20
            if pack:
                # ln == 0 (absent symbol) gives c_left == 0
                c_left = (e & 0xFFFF) << (32 - ln) & _M32
                r = used & 31
                j0 = used >> 5
                hi = c_left >> r
                lo = (c_left & ((1 << r) - 1)) << (32 - r)
                for q in range(4):
                    a[q] = a[q] | torch.where(j0 == q, hi, 0) | torch.where(
                        j0 + 1 == q, lo, 0)
            used = used + ln
            l4 = l4 + ln
        if sim_dec:
            valid = valid - l4
            refill = valid <= 64
            dev_d = pptr - mu
            dn[:, wi] = torch.minimum(dn[:, wi], torch.where(refill, dev_d, _BIG))
            dx[:, wi] = torch.maximum(dx[:, wi], torch.where(refill, dev_d, -_BIG))
            pptr = pptr + refill
            valid = valid + 64 * refill
        emit = used >= 64
        if pack:
            emit_pair(emit, base)
            a = [torch.where(emit, a[2], a[0]), torch.where(emit, a[3], a[1]),
                 torch.where(emit, 0, a[2]), torch.where(emit, 0, a[3])]
        else:
            dev_e = e_ptr - mu
            en[:, wi] = torch.minimum(en[:, wi], torch.where(emit, dev_e, _BIG))
            ex[:, wi] = torch.maximum(ex[:, wi], torch.where(emit, dev_e, -_BIG))
        e_ptr = e_ptr + emit
        used = used - 64 * emit
        if certify and laggard and (i + 1) % G == 0:
            base = torch.clamp(e_ptr.amin(dim=1, keepdim=True), 0, base_hi)

    bits = 64 * e_ptr + used
    flush = used > 0
    mu_last = ((nb - 1) * snum) >> 16
    if pack:
        fbase = base if laggard else window_base(nb - 1, n_win - 1)
        emit_pair(flush, fbase)
    else:
        dev_f = e_ptr - mu_last
        en[:, -1] = torch.minimum(en[:, -1], torch.where(flush, dev_f, _BIG))
        ex[:, -1] = torch.maximum(ex[:, -1], torch.where(flush, dev_f, -_BIG))
    return (None if pay is None else pay[:n_out_rows],
            *(v.to(torch.int32) for v in (bits, dn, dx, en, ex, viol)))


# ----------------------------------------------------------------------
# A4: schedule pass from code lengths
# ----------------------------------------------------------------------
def _n_tiles(data_i32, k):
    nb = k // 4
    if k % 4 or k <= 0 or data_i32.dim() != 2 or data_i32.shape[1] != ILS_LANES \
            or data_i32.shape[0] % nb:
        raise ValueError(
            f"data must be (n_tiles * k/4, {ILS_LANES}) int32 with k a "
            f"positive multiple of 4; got {tuple(data_i32.shape)}, k={k}"
        )
    return data_i32.shape[0] // nb


def ils_lengths_pass_plain(data_i32, snum, enc, *, k, rot=False):
    _, bits, dn, dx, en, ex, _ = _encode_plain(
        data_i32, enc, k=k, snum=snum, rot=rot, pack=False, certify=False,
        compact_dst=False,
    )
    return bits, dn, dx, en, ex


def ils_chunk_bits_plain(data_i32, enc, *, k, rot=False):
    """(n_tiles, C - 1, 1024) int32: each stream's code bits in every chunk
    of `certify_chunks(k)` but the last, as the bits kernel of A2, A4 and
    A5 writes them."""
    nb = k // 4
    n_tiles = data_i32.shape[0] // nb
    chunks, chunk_win = certify_chunks(k)
    cb = chunk_win * ILS_WIN
    x = _u32(data_i32).view(n_tiles, nb, ILS_LANES)
    if rot:
        src = _rot_src(k, data_i32.device)
        x = torch.gather(x, 2, src[None].expand(n_tiles, -1, -1))
    x = x[:, : (chunks - 1) * cb]
    lens = (enc >> 20).to(torch.int32)
    l4 = sum(lens[(x >> (8 * j)) & 255] for j in range(4))
    return l4.view(n_tiles, chunks - 1, cb, ILS_LANES).sum(
        dim=2, dtype=torch.int32)


def ils_lengths_pass(data_i32, snum, enc, *, k, rot=False, chunk_bits=False):
    """Schedule pass over (n_tiles*k//4, 1024) int32 data.

    Returns (bits (n_tiles, 1024), dec_min, dec_max, enc_min, enc_max —
    each (n_tiles, n_win, 1024) int32, per stream): total bits and the
    per-ILS_WIN-window refill/emission deviation envelopes relative to mu.
    With ``chunk_bits`` also the code bits of every chunk but the last,
    `ils_chunk_bits_plain`'s (n_tiles, C - 1, 1024), which `ils_pack` takes
    as ``cbits`` in place of computing them again.  On a CUDA tensor the
    bits kernel writes those chunk bits (C > 1), then one kernel over
    (tile, chunk) walks each chunk from its closed-form state.
    """
    n_tiles = _n_tiles(data_i32, k)
    _check("data_i32", data_i32, torch.int32)
    _check("enc", enc, torch.int32, (256,))
    _same_device(data_i32, enc)
    if not _use_kernel(data_i32):
        out = ils_lengths_pass_plain(data_i32, snum, enc, k=k, rot=rot)
        if chunk_bits:
            out += (ils_chunk_bits_plain(data_i32, enc, k=k, rot=rot),)
        return out
    n_win = ils_n_win(k)
    dev = data_i32.device
    bits = torch.empty((n_tiles, ILS_LANES), dtype=torch.int32, device=dev)
    env = [torch.empty((n_tiles, n_win, ILS_LANES), dtype=torch.int32,
                       device=dev) for _ in range(4)]
    chunks, chunk_win = certify_chunks(k)
    cbits = torch.empty((n_tiles, chunks - 1, ILS_LANES), dtype=torch.int32,
                        device=dev)
    rc = _lib("ils_encode").ils_lengths_launch(
        data_i32.data_ptr(), enc.data_ptr(), bits.data_ptr(),
        *(e.data_ptr() for e in env), cbits.data_ptr(), n_tiles, k,
        int(snum), int(bool(rot)), chunks, chunk_win, _stream(data_i32),
    )
    # one count per call, though a call of C > 1 chunks launches two kernels
    _launched(ils_lengths_pass, rc)
    return (bits, *env) + ((cbits,) if chunk_bits else ())


# ----------------------------------------------------------------------
# A2: fused certify + pack at worst-case stride
# ----------------------------------------------------------------------
def _certify_geometry(k, stride_rows, e_band, anchor, G=None):
    if anchor not in ("mu", "laggard"):
        raise ValueError("anchor must be 'mu' or 'laggard'")
    G = flush_group(k, e_band) if G is None else G
    cap_pairs = stride_rows // 2
    # the stale laggard base lags one flush (<= 2 retired pairs) behind
    W = min(e_band + G + (2 if anchor == "laggard" else 0), cap_pairs)
    return G, W, cap_pairs, -(e_band // 2)


def certify_chunks(k: int) -> tuple[int, int]:
    """(chunks C per stream, windows per chunk) of A2's CUDA kernels, of
    A5's, which run in their compact form, and of A4's: each
    stream's bodies cut into chunks of CERTIFY_CHUNK_WIN whole windows (the
    last one possibly shorter), so that a chunk writes its own envelope
    windows and starts at a flush boundary.  The grid is (tile, chunk):
    C = 4 at k=4096 gives the 256 MiB main section 256 blocks of 1024
    threads, one wave at two blocks on each of an H100's 132 SMs (8
    chunks, two waves, measured slower there); C = 1 where a stream
    has at most CERTIFY_CHUNK_WIN windows (k <= 1024, the k=8 tail).
    ``csrc/ils_encode.cu`` checks the same arithmetic."""
    return -(-ils_n_win(k) // CERTIFY_CHUNK_WIN), CERTIFY_CHUNK_WIN


def ils_pack_certify_plain(data_i32, snum, enc, *, k, stride_rows, rot=False,
                           e_band=FUSED_E_BAND, anchor="mu", G=None):
    n_tiles = data_i32.shape[0] // (k // 4)
    G, W, cap_pairs, boff_est = _certify_geometry(k, stride_rows, e_band,
                                                  anchor, G)
    row0 = torch.arange(n_tiles, device=data_i32.device) * stride_rows
    pay, bits, dn, dx, _, _, viol = _encode_plain(
        data_i32, enc, k=k, snum=snum, rot=rot, pack=True, certify=True,
        compact_dst=False, n_out_rows=(n_tiles + 1) * stride_rows, row0=row0,
        G=G, W=W, cap_pairs=cap_pairs, boff_est=boff_est,
        laggard=anchor == "laggard",
    )
    return _to_i32(pay), bits, dn, dx, viol


def ils_pack_certify(data_i32, snum, enc, *, k, stride_rows, rot=False,
                     e_band=FUSED_E_BAND, anchor="mu"):
    """Fused single-pass encode at worst-case tile stride.

    Returns (payload_strided ((n_tiles + 1) * stride_rows, 1024), bits,
    dec_min, dec_max, viol): bits and viol are (n_tiles, 1024), the
    envelopes (n_tiles, n_win, 1024), all int32.  The trailing stride_rows
    rows are zero slack for `ils_compact`.  Any nonzero viol voids the
    payload (an emission left the ``anchor``-placed window of ``e_band``
    pairs) and the caller escalates the anchor or takes the two-pass path.
    """
    return _pack_certify_launch(ils_pack_certify, data_i32, snum, enc, k=k,
                                stride_rows=stride_rows, rot=rot,
                                e_band=e_band, anchor=anchor,
                                G=flush_group(k, e_band))


def _pack_certify_launch(wrapper, data_i32, snum, enc, *, k, stride_rows, rot,
                         e_band, anchor, G):
    """A2 at flush cadence G: its kernel for a CUDA tensor, counted as a
    launch of `wrapper`, its plain version for a CPU tensor."""
    n_tiles = _n_tiles(data_i32, k)
    _check("data_i32", data_i32, torch.int32)
    _check("enc", enc, torch.int32, (256,))
    _same_device(data_i32, enc)
    G, W, cap_pairs, boff_est = _certify_geometry(k, stride_rows, e_band,
                                                  anchor, G)
    if not _use_kernel(data_i32):
        return ils_pack_certify_plain(data_i32, snum, enc, k=k,
                                      stride_rows=stride_rows, rot=rot,
                                      e_band=e_band, anchor=anchor, G=G)
    n_win = ils_n_win(k)
    dev = data_i32.device
    # zero-filled: rows past a stream's end and the slack stay zero
    pay = torch.zeros(((n_tiles + 1) * stride_rows, ILS_LANES),
                      dtype=torch.int32, device=dev)
    bits = torch.empty((n_tiles, ILS_LANES), dtype=torch.int32, device=dev)
    dn = torch.empty((n_tiles, n_win, ILS_LANES), dtype=torch.int32, device=dev)
    dx = torch.empty_like(dn)
    viol = torch.empty_like(bits)
    # the code bits of every chunk but the last
    chunks, chunk_win = certify_chunks(k)
    cbits = torch.empty((n_tiles, chunks - 1, ILS_LANES), dtype=torch.int32,
                        device=dev)
    rc = _lib("ils_encode").ils_pack_certify_launch(
        data_i32.data_ptr(), enc.data_ptr(), pay.data_ptr(), bits.data_ptr(),
        dn.data_ptr(), dx.data_ptr(), viol.data_ptr(), cbits.data_ptr(),
        n_tiles, k, int(snum), int(bool(rot)), G, W, cap_pairs, boff_est,
        int(anchor == "laggard"), int(stride_rows), chunks, chunk_win,
        _stream(data_i32),
    )
    # one count per call, though a call of C > 1 chunks launches two kernels
    _launched(wrapper, rc)
    return pay, bits, dn, dx, viol


# ----------------------------------------------------------------------
# D1: the streaming fused pack, on A2's kernel
# ----------------------------------------------------------------------
def ils_stream_span_rows(k, stride_rows, e_band=FUSED_E_BAND,
                         chunk_cap=CHUNK_I):
    """Rows of the TPU streaming pack's sliding window, or None where that
    pack is not viable (a single chunk, or a span no narrower than the
    stride).  The span decides, in `ops.ils.ils_encode_to_device`, whether
    the streaming tier may encode a section (format policy)."""
    iters = _chunk_iters(k, chunk_cap)
    if (k // 4) // iters < 2:
        return None
    span_rows = 2 * (iters + min(e_band + 2, stride_rows // 2) + 4)
    return None if span_rows > stride_rows else span_rows


def _stream_flush_group(k, e_band, chunk_cap, flush_g):
    if flush_g is not None and flush_g not in (1, 2):
        raise ValueError("flush_g must be 1 or 2")
    return 1 if flush_g == 1 else flush_group(k, e_band, chunk_cap)


def ils_pack_certify_stream_plain(data_i32, snum, enc, *, k, stride_rows,
                                  rot=False, flush_g=None,
                                  e_band=FUSED_E_BAND, chunk_cap=CHUNK_I,
                                  anchor="mu"):
    return ils_pack_certify_plain(
        data_i32, snum, enc, k=k, stride_rows=stride_rows, rot=rot,
        e_band=e_band, anchor=anchor,
        G=_stream_flush_group(k, e_band, chunk_cap, flush_g))


def ils_pack_certify_stream(data_i32, snum, enc, *, k, stride_rows, rot=False,
                            flush_g=None, e_band=FUSED_E_BAND,
                            chunk_cap=CHUNK_I, anchor="mu"):
    """The streaming fused pack (TPU kernel D1), computed by A2's kernel.

    The TPU kernel holds only the live span of pairs in VMEM and ships it
    chunk by chunk; its bits, envelopes and violation flags are A2's, and
    its payload rows [0, w_tile) of each tile too.  A2 writes every row of
    the full stride here, so nothing of the TPU's window survives but its
    flush cadence: the stream kernel chunks by ``chunk_cap``, which sets G
    (`flush_group`) and with it the window W and the flags.  Same return
    as `ils_pack_certify`; the rows past a tile's w_tile are zero here
    (unspecified on the TPU).  Raises where the TPU kernel is not viable
    (`ils_stream_span_rows` is None)."""
    if anchor not in ("mu", "laggard"):
        raise ValueError("anchor must be 'mu' or 'laggard'")
    G = _stream_flush_group(k, e_band, chunk_cap, flush_g)
    if ils_stream_span_rows(k, stride_rows, e_band, chunk_cap) is None:
        raise ValueError("streaming pack not viable; use ils_pack_certify")
    return _pack_certify_launch(ils_pack_certify_stream, data_i32, snum, enc,
                                k=k, stride_rows=stride_rows, rot=rot,
                                e_band=e_band, anchor=anchor, G=G)


# ----------------------------------------------------------------------
# A5: two-pass pack at the certified row starts
# ----------------------------------------------------------------------
def _pack_geometry(k, w_cap, w_band):
    G = flush_group(k, w_band)
    cap_pairs = w_cap // 2
    return G, min(w_band + G, cap_pairs), cap_pairs


def ils_pack_plain(data_i32, snum, boffs, row_starts, enc, *, k, w_cap,
                   w_band, total_rows, rot=False):
    G, W, cap_pairs = _pack_geometry(k, w_cap, w_band)
    n_tiles = data_i32.shape[0] // (k // 4)
    pay, *_ = _encode_plain(
        data_i32, enc, k=k, snum=snum, rot=rot, pack=True, certify=False,
        compact_dst=True, n_out_rows=total_rows + w_cap, row0=row_starts,
        G=G, W=W, cap_pairs=cap_pairs,
        boffs=boffs.reshape(n_tiles, ils_n_win(k)),
    )
    return _to_i32(pay)


def ils_pack(data_i32, snum, boffs, row_starts, enc, *, k, w_cap, w_band,
             total_rows, rot=False, cbits=None):
    """Pack pass: returns compact payload rows (total_rows + w_cap, 1024).

    boffs: (n_tiles, n_win) int32 windowed emission band anchors (the exact
    envelope of `ils_lengths_pass`); row_starts: (n_tiles,) int32 compact
    row offsets, taken on trust (`ops.ils.row_starts_of`): a pair that would
    land outside the output is skipped, not checked on the host.  The
    trailing w_cap rows are zero slack.  On a CUDA tensor A2's two kernels
    in their compact form compute it over `certify_chunks(k)` chunks of
    each stream; ``cbits``, the chunk bits of `ils_lengths_pass` on the
    same data (``chunk_bits=True``), spares the kernel that computes them
    (the plain version needs none)."""
    n_tiles = _n_tiles(data_i32, k)
    n_win = ils_n_win(k)
    chunks, chunk_win = certify_chunks(k)
    _check("data_i32", data_i32, torch.int32)
    _check("enc", enc, torch.int32, (256,))
    _check("boffs", boffs, torch.int32, (n_tiles, n_win))
    _check("row_starts", row_starts, torch.int32, (n_tiles,))
    _same_device(data_i32, enc, boffs, row_starts)
    if cbits is not None:
        _check("cbits", cbits, torch.int32, (n_tiles, chunks - 1, ILS_LANES))
        _same_device(data_i32, cbits)
    G, W, cap_pairs = _pack_geometry(k, w_cap, w_band)
    if not _use_kernel(data_i32):
        return ils_pack_plain(data_i32, snum, boffs, row_starts, enc, k=k,
                              w_cap=w_cap, w_band=w_band,
                              total_rows=total_rows, rot=rot)
    dev = data_i32.device
    # zero-filled: rows past a stream's end and the slack stay zero
    pay = torch.zeros((total_rows + w_cap, ILS_LANES), dtype=torch.int32,
                      device=dev)
    # A2's chunks and bits kernel: the code bits of every chunk but the
    # last, unless the caller has them
    have_cbits = cbits is not None
    if not have_cbits:
        cbits = torch.empty((n_tiles, chunks - 1, ILS_LANES),
                            dtype=torch.int32, device=dev)
    rc = _lib("ils_encode").ils_pack_launch(
        data_i32.data_ptr(), enc.data_ptr(), boffs.data_ptr(),
        row_starts.data_ptr(), pay.data_ptr(), cbits.data_ptr(), n_tiles, k,
        int(snum), int(bool(rot)), G, W, cap_pairs, total_rows + w_cap,
        chunks, chunk_win, int(have_cbits), _stream(data_i32),
    )
    # one count per call, though a call of C > 1 chunks without cbits
    # launches two kernels
    _launched(ils_pack, rc)
    return pay


# ----------------------------------------------------------------------
# A3: compaction of the strided fused-pack payload
# ----------------------------------------------------------------------
def _tile_rows(row_starts, total_rows):
    ends = torch.cat([row_starts[1:].to(torch.int64),
                      torch.tensor([total_rows], device=row_starts.device)])
    return ends - row_starts.to(torch.int64)


def ils_compact_plain(payload_strided, row_starts, *, stride_rows, w_cap,
                      total_rows):
    """Gathers each tile's rows: compact row r of tile t is strided row
    t*stride_rows + (r - row_starts[t]); the w_cap slack rows are zero."""
    dev = payload_strided.device
    counts = _tile_rows(row_starts, total_rows)
    tile = torch.repeat_interleave(
        torch.arange(row_starts.shape[0], device=dev), counts)
    r = torch.arange(total_rows, device=dev)
    src = tile * stride_rows + r - row_starts.to(torch.int64)[tile]
    out = torch.zeros((total_rows + w_cap, ILS_LANES), dtype=torch.int32,
                      device=dev)
    out[:total_rows] = payload_strided[src]
    return out


def ils_compact(payload_strided, row_starts, *, stride_rows, w_cap,
                total_rows):
    """Compact a strided fused-pack payload to the dense layout
    (total_rows + w_cap slack rows, 1024) int32.

    row_starts: (n_tiles,) int32 prefix sum of the tiles' rows, each at
    most stride_rows, taken on trust (`ops.ils.row_starts_of`); the kernel
    clamps every tile's copy into both buffers instead of a host check."""
    n_tiles = row_starts.shape[0]
    _check("payload_strided", payload_strided, torch.int32)
    _check("row_starts", row_starts, torch.int32, (n_tiles,))
    _same_device(payload_strided, row_starts)
    if payload_strided.dim() != 2 or payload_strided.shape[1] != ILS_LANES \
            or payload_strided.shape[0] < n_tiles * stride_rows:
        raise ValueError(
            f"payload_strided must hold {n_tiles} tiles of {stride_rows} rows "
            f"of {ILS_LANES} lanes; got {tuple(payload_strided.shape)}"
        )
    if not _use_kernel(payload_strided):
        return ils_compact_plain(payload_strided, row_starts,
                                 stride_rows=stride_rows, w_cap=w_cap,
                                 total_rows=total_rows)
    # every row is written: the tiles' rows cover [0, total_rows) and the
    # kernel zeroes the w_cap slack rows
    out = torch.empty((total_rows + w_cap, ILS_LANES), dtype=torch.int32,
                      device=payload_strided.device)
    rc = _lib("ils_compact").ils_compact_launch(
        payload_strided.data_ptr(), row_starts.data_ptr(), out.data_ptr(),
        n_tiles, int(stride_rows), int(total_rows), int(w_cap),
        _stream(payload_strided),
    )
    _launched(ils_compact, rc)
    return out


# ----------------------------------------------------------------------
# A1: decode
# ----------------------------------------------------------------------
def ils_decode_plain(payload_rows, row_starts, dec: IlsDecTabs, *, k, w_cap,
                     n_tiles, max_len, min_len=1, rot=False):
    dev = payload_rows.device
    nb = k // 4
    cap_pairs = w_cap // 2
    min_len = max(min(min_len, max_len), 1)
    pay = _u32(payload_rows)
    n_rows = pay.shape[0]
    lim = _u32(dec.lim)
    bias = dec.bias.to(torch.int64)
    symtab = dec.symtab.to(torch.int64)
    starts = row_starts.to(torch.int64).view(n_tiles, 1)
    lanes = torch.arange(ILS_LANES, device=dev)[None, :]

    if n_rows == 0:
        pay = torch.zeros((1, ILS_LANES), dtype=torch.int64, device=dev)

    def rows(r):
        # rows outside the payload read as zeros (no slack rows needed)
        idx = starts + r
        got = pay[torch.clamp(idx, 0, max(n_rows - 1, 0)), lanes]
        return torch.where((idx >= 0) & (idx < n_rows), got, 0)

    a = [rows(j) for j in range(4)]  # 128-bit register, MSB-first u32 words
    shape = a[0].shape
    valid = torch.full(shape, 128, dtype=torch.int64, device=dev)
    pptr = torch.full(shape, 2, dtype=torch.int64, device=dev)
    out = torch.zeros((n_tiles, nb, ILS_LANES), dtype=torch.int64, device=dev)
    dst = _rot_src(k, dev) if rot else None
    for i in range(nb):
        pack = torch.zeros(shape, dtype=torch.int64, device=dev)
        for j in range(4):
            win = a[0]
            ln = torch.full(shape, min_len, dtype=torch.int64, device=dev)
            for lv in range(min_len, max_len):
                ln = ln + (win >= lim[lv])
            rank = bias[ln] + (win >> (32 - ln))
            pack = pack | (symtab[rank & 255] << (8 * j))
            for q in range(3):
                a[q] = ((a[q] << ln) | (a[q + 1] >> (32 - ln))) & _M32
            a[3] = (a[3] << ln) & _M32
            valid = valid - ln
        # refill: pairs at or past the tile's pair capacity read as zeros
        need = valid <= 64
        load = need & (pptr < cap_pairs)
        w0 = torch.where(load, rows(2 * pptr), 0)
        w1 = torch.where(load, rows(2 * pptr + 1), 0)
        r = valid & 31
        j0 = valid >> 5  # word holding bit offset `valid`; valid in [1, 64]
        hi0, hi1 = w0 >> r, w1 >> r
        lo0 = (w0 & ((1 << r) - 1)) << (32 - r)
        lo1 = (w1 & ((1 << r) - 1)) << (32 - r)
        for q in range(4):
            a[q] = (a[q] | torch.where(j0 == q, hi0, 0)
                    | torch.where(j0 + 1 == q, lo0 | hi1, 0)
                    | torch.where(j0 + 2 == q, lo1, 0))
        pptr = pptr + need
        valid = valid + 64 * need
        if dst is None:
            out[:, i, :] = pack
        else:
            out[:, i, dst[i]] = pack
    return _to_i32(out.view(n_tiles * nb, ILS_LANES))


def ils_decode_lut(dec: IlsDecTabs, *, max_len, min_len=1,
                   bits=ILS_LUT_BITS) -> torch.Tensor:
    """(2**bits,) int64: the table each block of A1's kernel builds in
    shared memory (``csrc/ils_decode.cu:build_lut``), its plain mirror.

    Entry x is ``(len << 8) | symbol`` when the compare chain gives the
    lowest and the highest window with prefix x the same length len <=
    bits (the chain never falls as the window grows, so then it decides
    every window of the prefix), else 0: those windows take the chain."""
    min_len = max(min(min_len, max_len), 1)
    lim = _u32(dec.lim)
    bias = dec.bias.to(torch.int64)
    symtab = dec.symtab.to(torch.int64)
    lo = torch.arange(1 << bits, dtype=torch.int64, device=dec.lim.device) \
        << (32 - bits)
    hi = lo | (_M32 >> bits)

    def length(win):
        ln = torch.full_like(win, min_len)
        for lv in range(min_len, max_len):
            ln = ln + (win >= lim[lv])
        return ln

    ln = length(lo)
    rank = bias[ln] + (lo >> (32 - ln))
    entry = (ln << 8) | symtab[rank & 255]
    return torch.where((ln <= bits) & (length(hi) == ln), entry, 0)


def ils_decode(payload_rows, row_starts, dec: IlsDecTabs, *, k, w_cap,
               n_tiles, max_len, min_len=1, rot=False):
    """Decode n_tiles tiles: returns (n_tiles * k//4, 1024) int32, the
    original u32 data.

    payload_rows: (total_rows, 1024) int32, with or without slack rows: rows
    outside it read as zeros, so a corrupt row_starts stays inside the
    buffer and the caller appends no slack; row_starts: (n_tiles,) int32.
    Refills load pair pptr directly; pairs at or past w_cap // 2 read as
    zeros (the TPU window clamp), which the certified band makes equivalent
    to the banded window, so neither boffs nor w_band reach the kernel (the
    caller checks the band).  The kernel takes each codeword's length and
    symbol from a table on the top ``ILS_LUT_BITS`` bits of the window
    (`ils_decode_lut`), the compare chain where that table has no entry;
    the plain version runs the chain for every codeword."""
    _check("payload_rows", payload_rows, torch.int32)
    _check("row_starts", row_starts, torch.int32, (n_tiles,))
    for name, x, n in (("lim", dec.lim, 32), ("bias", dec.bias, 32),
                       ("symtab", dec.symtab, 256)):
        _check(name, x, torch.int32, (n,))
    _same_device(payload_rows, row_starts, *dec)
    if payload_rows.dim() != 2 or payload_rows.shape[1] != ILS_LANES:
        raise ValueError(f"payload_rows must be (rows, {ILS_LANES})")
    if w_cap < 4:
        raise ValueError(f"w_cap={w_cap} below the 4-row register init")
    if not 1 <= max_len <= 16 or k % 4 or k <= 0:
        raise ValueError(f"invalid decode shape k={k}, max_len={max_len}")
    min_len = max(min(min_len, max_len), 1)
    if not _use_kernel(payload_rows):
        return ils_decode_plain(payload_rows, row_starts, dec, k=k,
                                w_cap=w_cap, n_tiles=n_tiles, max_len=max_len,
                                min_len=min_len, rot=rot)
    out = torch.empty((n_tiles * (k // 4), ILS_LANES), dtype=torch.int32,
                      device=payload_rows.device)
    if n_tiles == 0:
        return out
    rc = _lib("ils_decode").ils_decode_launch(
        payload_rows.data_ptr(), row_starts.data_ptr(), dec.lim.data_ptr(),
        dec.bias.data_ptr(), dec.symtab.data_ptr(), out.data_ptr(), n_tiles, k,
        int(w_cap), min_len, max_len, int(bool(rot)), payload_rows.shape[0],
        ILS_LUT_BITS, _stream(payload_rows),
    )
    _launched(ils_decode, rc)
    return out


_WRAPPERS = (ils_decode, ils_pack_certify, ils_compact, ils_lengths_pass,
             ils_pack, ils_pack_certify_stream)
_NAMES = tuple(fn.__name__ for fn in _WRAPPERS)


def reset_launch_counts() -> None:
    trace.reset_launches(_NAMES)


def launch_counts() -> dict[str, int]:
    return trace.launches(_NAMES)
