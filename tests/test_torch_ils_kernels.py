"""ILS kernels of the PyTorch port held against the JAX package.

The same seeded NumPy inputs go through each JAX kernel wrapper (Pallas in
interpret mode, as the JAX suite runs it on the CPU) and through the port's
wrapper on CPU tensors, which runs the kernel's plain PyTorch version.  All
outputs are integers and must be equal (tolerance 0).  The CUDA kernels
themselves are held against the plain versions on a card by
`tests/test_torch_cuda.py`, which imports no JAX.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import huffman_tpu.ops.ils as jils
from huffman_tpu.core import canonical_code_table, npref, package_merge_lengths
from huffman_tpu.core.canonical import chain_spec as jax_chain_spec
from huffman_tpu.core.ils_ref import ILS_LANES, ils_schedule_numer
from huffman_tpu.ops.pallas import ils_kernels as jk
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch.core.canonical import chain_spec as port_chain_spec
from huffman_tpu_torch.core.ils_ref import rot_src_index
from huffman_tpu_torch.io.convert import code_table_from_numpy, section_from_numpy
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk


def _fit(data, max_len=16):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), max_len), max_len
    )


def _case(data, k):
    """(JAX table, port table, snum, JAX data_i32, port data_i32, max_len)."""
    jt = _fit(data)
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    avg = float(jt.lengths.astype(np.int64)[data].mean())
    snum = ils_schedule_numer(avg)
    words = np.ascontiguousarray(data).view("<u4").view(np.int32)
    return (jt, pt, snum, jnp.asarray(words.reshape(-1, 8, 128)),
            torch.from_numpy(words.reshape(-1, ILS_LANES).copy()),
            int(jt.max_len_present))


def _jparams(snum):
    return jnp.asarray(np.array([snum, 0], np.int32))


def _eq(jax_out, port_out):
    j = np.asarray(jax_out)
    p = port_out.numpy()
    return np.array_equal(j.reshape(p.shape), p)


def _eq_env(jax_env, port_env):
    """Per lane and after the lane reduction the caller does."""
    j = np.asarray(jax_env).reshape(port_env.shape)
    p = port_env.numpy()
    return (np.array_equal(j, p)
            and np.array_equal(j.min(axis=-1), p.min(axis=-1))
            and np.array_equal(j.max(axis=-1), p.max(axis=-1)))


def _heterogeneous(k):
    # first half zeros, second half uniform: common-mode schedule drift
    n = k * ILS_LANES
    data = np.zeros(n, np.uint8)
    data[n // 2:] = generate_redundant(n // 2, 0.0, seed=17)
    return data


def test_tables_match():
    data = generate_redundant(2 * 12 * ILS_LANES, 0.5, seed=4)
    jt = _fit(data)
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    je, jd = jk.ils_enc_tabs(jt), jk.ils_dec_tabs(jt)
    enc = tk.ils_enc_tabs(pt, device="cpu")
    dec = tk.ils_dec_tabs(pt, device="cpu")
    assert np.array_equal(enc.numpy()[:128], np.asarray(je.lo)[0])
    assert np.array_equal(enc.numpy()[128:], np.asarray(je.hi)[0])
    assert np.array_equal(dec.lim.numpy().view(np.uint32), np.asarray(jd.lim)[0])
    assert np.array_equal(dec.bias.numpy(), np.asarray(jd.bias)[0, :32])
    sym = np.concatenate([np.asarray(jd.sym_lo)[0], np.asarray(jd.sym_hi)[0]])
    assert np.array_equal(dec.symtab.numpy(), sym)
    for name in ("codes", "lim_left", "symtab", "offsets", "first_code"):
        assert np.array_equal(getattr(pt, name), getattr(jt, name)), name
    assert port_chain_spec(pt) == jax_chain_spec(jt)


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("r", [0.0, 0.5, 0.9])
def test_lengths_pass_matches(r, rot):
    k = 12
    data = generate_redundant(2 * k * ILS_LANES, r, seed=4)
    jt, pt, snum, jd, td, _ = _case(data, k)
    ref = jk.ils_lengths_pass(jd, _jparams(snum), jk.ils_enc_tabs(jt), k=k,
                              rot=rot, interpret=True)
    got = tk.ils_lengths_pass(td, snum, tk.ils_enc_tabs(pt, device="cpu"), k=k, rot=rot)
    assert _eq(ref[0], got[0])
    for name, a, b in zip(("dn", "dx", "en", "ex"), ref[1:], got[1:]):
        assert _eq_env(a, b), name


@pytest.mark.parametrize("k,r,rot,anchor", [
    (12, 0.0, False, "mu"), (12, 0.0, True, "laggard"),
    (12, 0.5, False, "laggard"), (12, 0.5, True, "mu"),
    (12, 0.9, False, "mu"), (12, 0.9, True, "laggard"),
    (64, 0.5, True, "laggard"),
])
def test_pack_certify_matches(k, r, rot, anchor):
    # k=12 flushes every body (odd TPU chunk), k=64 every two bodies
    data = generate_redundant(2 * k * ILS_LANES, r, seed=4)
    jt, pt, snum, jd, td, ml = _case(data, k)
    stride_rows = max(2 * (-(-k * ml // 64)), 4)
    kw = dict(k=k, stride_rows=stride_rows, rot=rot, anchor=anchor)
    ref = jk.ils_pack_certify(jd, _jparams(snum), jk.ils_enc_tabs(jt),
                              interpret=True, **kw)
    got = tk.ils_pack_certify(td, snum, tk.ils_enc_tabs(pt, device="cpu"), **kw)
    for name, a, b in zip(("pay", "bits", "dn", "dx", "viol"), ref, got):
        assert _eq_env(a, b) if name in ("dn", "dx") else _eq(a, b), name


@pytest.mark.parametrize("k,r,rot", [
    (12, 0.0, False), (12, 0.0, True), (12, 0.5, False), (12, 0.5, True),
    (12, 0.9, False), (12, 0.9, True), (64, 0.5, True),
])
def test_pack_matches(k, r, rot):
    data = generate_redundant(2 * k * ILS_LANES, r, seed=4)
    jt, pt, snum, jd, td, _ = _case(data, k)
    n_tiles = 2
    bits, dmin, dmax, emin, emax = jk.ils_lengths_pass(
        jd, _jparams(snum), jk.ils_enc_tabs(jt), k=k, rot=rot, interpret=True)
    enc_min = np.asarray(jnp.min(emin, axis=(2, 3)))
    enc_max = np.asarray(jnp.max(emax, axis=(2, 3)))
    w_band_enc = jils.round_band(
        int(np.maximum(enc_max - enc_min, 0).max(initial=0)) + 2)
    w_tiles = np.maximum(2 * (-(-np.asarray(bits).max(axis=(1, 2)) // 64)), 4)
    p = jils.certify_params(
        k=k, snum=snum, n_tiles=n_tiles, w_tiles=w_tiles.astype(np.int64),
        dec_min=np.asarray(jnp.min(dmin, axis=(2, 3))),
        dec_max=np.asarray(jnp.max(dmax, axis=(2, 3))),
        extra_band_pairs=w_band_enc, rot=rot)
    boffs = np.where(enc_min <= enc_max, enc_min, 0).astype(np.int32)
    starts = p.row_starts[:-1].astype(np.int32)
    kw = dict(k=k, w_cap=p.w_cap, w_band=w_band_enc, total_rows=p.total_rows,
              rot=rot)
    ref = jk.ils_pack(jd, _jparams(snum), jnp.asarray(boffs),
                      jnp.asarray(starts), jk.ils_enc_tabs(jt),
                      interpret=True, **kw)
    got = tk.ils_pack(td, snum, torch.from_numpy(boffs),
                      torch.from_numpy(starts), tk.ils_enc_tabs(pt, device="cpu"), **kw)
    assert _eq(np.asarray(ref)[: p.total_rows], got[: p.total_rows])
    assert not got[p.total_rows:].any()


def test_violation_flag_matches_skewed_stream():
    # one stream of all-rare codes escapes a 2-pair band within a few
    # bodies (the JAX suite's violation case)
    k = 48
    n = k * ILS_LANES
    data = np.zeros(n, np.uint8)
    rare = np.arange(1, 256, dtype=np.uint8)
    data[::129] = rare[np.arange((n + 128) // 129) % 255]
    u32_idx = np.arange(5, n // 4, ILS_LANES)  # stream 5: all rare bytes
    byte_idx = (u32_idx[:, None] * 4 + np.arange(4)[None]).reshape(-1)
    data[byte_idx] = rare[np.arange(byte_idx.size) % 255]
    jt, pt, snum, jd, td, ml = _case(data, k)
    kw = dict(k=k, stride_rows=max(2 * (-(-k * ml // 64)), 4), e_band=2)
    ref = jk.ils_pack_certify(jd, _jparams(snum), jk.ils_enc_tabs(jt),
                              interpret=True, **kw)
    got = tk.ils_pack_certify(td, snum, tk.ils_enc_tabs(pt, device="cpu"), **kw)
    assert int(got[4].max()) == 1
    for name, a, b in zip(("pay", "bits", "dn", "dx", "viol"), ref, got):
        assert _eq(a, b), name


@pytest.mark.parametrize("anchor,want", [("mu", 1), ("laggard", 0)])
def test_anchor_flags_match_heterogeneous(anchor, want):
    # zeros-then-uniform drifts every lane together: "mu" violates, the
    # laggard anchor absorbs the common-mode drift
    k = 256
    data = _heterogeneous(k)
    jt, pt, snum, jd, td, ml = _case(data, k)
    kw = dict(k=k, stride_rows=max(2 * (-(-k * ml // 64)), 4), e_band=8,
              anchor=anchor)
    ref = jk.ils_pack_certify(jd, _jparams(snum), jk.ils_enc_tabs(jt),
                              interpret=True, **kw)
    got = tk.ils_pack_certify(td, snum, tk.ils_enc_tabs(pt, device="cpu"), **kw)
    assert int(got[4].max()) == want
    for name, a, b in zip(("pay", "bits", "dn", "dx", "viol"), ref, got):
        assert _eq(a, b), name


# ----------------------------------------------------------------------
# A2 over chunked streams: a NumPy model of csrc/ils_encode.cu
# ----------------------------------------------------------------------
_U64 = np.uint64
_Z64 = np.uint64(0)


def _shl(x, n):
    """x << n on uint64, 0 where n >= 64 (n >= 0)."""
    n = np.asarray(n)
    return np.where(n >= 64, _Z64, x << np.minimum(n, 63).astype(_U64))


def _shr(x, n):
    """x >> n on uint64, 0 where n >= 64 (n >= 0)."""
    n = np.asarray(n)
    return np.where(n >= 64, _Z64, x >> np.minimum(n, 63).astype(_U64))


def _chunk_bounds(nb, G, C):
    """Start bodies of up to C chunks of whole flush groups, and nb."""
    step = G * -(-nb // (G * C))
    return list(range(0, nb, step)) + [nb]


_RING = 8  # pair slots of a warp's ring (CERT_RING in csrc/ils_encode.cu)


def _pack_chunked(words, enc, *, k, snum, rot, G, bounds, W, cap_pairs,
                  boff, laggard, row0, n_rows, flush_to_base):
    """The two kernels of A2 and A5 on chunks [bounds[c], bounds[c + 1]) of
    every stream: the bits pass (each chunk's code bits), then each chunk
    from the closed-form state at its start (e_ptr = cum >> 6, used = cum &
    63), its accumulator seeded with the last `used` code bits before it
    (the codes walked back from its start), its laggard base the tile
    minimum of e_ptr there.  Pairs go through each warp's ring of _RING
    slots: a pair within _RING of the warp's `flushed` pair waits in slot e
    % _RING, the others are stored at once; after every body the warp
    stores its final pairs up to its minimum e_ptr, or up to the window
    base where `flush_to_base` (A2's rule, which needs a base that never
    falls).  `boff` is A2's "mu" offset (an int) or A5's (n_tiles, n_win)
    anchors; pair e of tile t goes to rows row0[t] + 2e, skipped outside
    [0, n_rows).  Returns (payload, bits, dn, dx, viol) as NumPy arrays."""
    nb = k // 4
    n_tiles = words.shape[0] // nb
    x = words.view(np.uint32).reshape(n_tiles, nb, ILS_LANES)
    src = rot_src_index(k) if rot else None
    tab = enc.astype(np.int64)
    lens, codes = tab >> 20, (tab & 0xFFFF).astype(_U64)
    base_hi = cap_pairs - W
    n_win = -(-nb // 64)
    shape = (n_tiles, ILS_LANES)
    t_idx, s_idx = np.indices(shape)
    anchors = np.broadcast_to(np.asarray(boff, np.int64).reshape(
        (n_tiles, n_win) if np.ndim(boff) else (1, 1)), (n_tiles, n_win))

    def codes_of(i):
        w = (x[:, i, :] if src is None else x[:, i, src[i]]).astype(np.int64)
        for j in range(4):
            sym = (w >> (8 * j)) & 255
            yield lens[sym], codes[sym]

    def mu(i):
        return (i * snum) >> 16

    def window_base(i):
        return np.clip(mu(i) + anchors[:, i // 64 : i // 64 + 1], 0, base_hi)

    cbits = []
    for b0, b1 in zip(bounds[:-2], bounds[1:-1]):
        bits = np.zeros(shape, np.int64)
        for i in range(b0, b1):
            for ln, _ in codes_of(i):
                bits += ln
        cbits.append(bits)

    pay = np.zeros((n_rows, ILS_LANES), np.uint32)
    dn = np.full((n_tiles, n_win, ILS_LANES), 1 << 30, np.int64)
    dx = -dn
    viol = np.zeros(shape, bool)
    row0 = np.asarray(row0, np.int64).reshape(n_tiles, 1)

    def store(mask, e, v):
        r = row0 + 2 * e
        ok = mask & (r >= 0) & (r + 1 < n_rows)
        pay[r[ok], s_idx[ok]] = (v[ok] >> _U64(32)).astype(np.uint32)
        pay[r[ok] + 1, s_idx[ok]] = (v[ok] & _U64(0xFFFFFFFF)).astype(np.uint32)

    def warps(a):  # a warp's value on each of its lanes
        return np.repeat(a, 32, axis=1)

    for c, (b0, b1) in enumerate(zip(bounds[:-1], bounds[1:])):
        cum = sum(cbits[:c], np.zeros(shape, np.int64))
        used, e_ptr = cum & 63, cum >> 6
        seed, n = np.zeros(shape, _U64), np.zeros(shape, np.int64)
        for i in range(b0 - 1, -1, -1):
            if not (n < used).any():
                break
            for ln, code in reversed(list(codes_of(i))):
                more = n < used
                seed = np.where(more, seed | _shl(code, n), seed)
                n = np.where(more, n + ln, n)
        hi = np.where(used > 0, _shl(seed, 64 - used), _Z64)
        lo = np.zeros(shape, _U64)
        tile_min = lambda: np.clip(e_ptr.min(axis=1, keepdims=True), 0, base_hi)
        base = tile_min() if laggard else 0
        warp_min = lambda: e_ptr.reshape(n_tiles, -1, 32).min(axis=2)
        flushed = warp_min()
        ring = np.zeros(shape + (_RING,), _U64)
        held = np.zeros(shape + (_RING,), bool)

        def retire(mask, base):
            nonlocal viol
            rel = e_ptr - base
            ok = mask & (rel >= 0) & (rel < W)
            viol = viol | (mask & ~ok)
            in_ring = ok & (e_ptr - warps(flushed) < _RING)
            slot = e_ptr & (_RING - 1)
            ring[t_idx[in_ring], s_idx[in_ring], slot[in_ring]] = hi[in_ring]
            held[t_idx[in_ring], s_idx[in_ring], slot[in_ring]] = True
            store(ok & ~in_ring, e_ptr, hi)

        def flush(upto):
            nonlocal flushed
            for d in range(_RING):
                e = warps(flushed + d)
                slot = e & (_RING - 1)
                h = held[t_idx, s_idx, slot] & (e < warps(upto))
                store(h, e, ring[t_idx, s_idx, slot])
                held[t_idx[h], s_idx[h], slot[h]] = False
            flushed = np.maximum(flushed, upto)

        for i in range(b0, b1):
            if not laggard and i % G == 0:
                base = window_base(i)
            for ln, code in codes_of(i):
                has = ln > 0
                left = np.where(has, _shl(code, 64 - ln), _Z64)
                low = used < 64
                hi = hi | np.where(low, _shr(left, used), _Z64)
                lo = lo | np.where(low, _shl(left, 64 - used),
                                   _shr(left, np.maximum(used - 64, 0)))
                used = used + ln
            emit = used >= 64
            # the decoder refills exactly where a pair retires, at pptr =
            # 2 + e_ptr
            dev, wi = 2 + e_ptr - mu(i), i // 64
            dn[:, wi] = np.where(emit, np.minimum(dn[:, wi], dev), dn[:, wi])
            dx[:, wi] = np.where(emit, np.maximum(dx[:, wi], dev), dx[:, wi])
            retire(emit, base)
            hi, lo = np.where(emit, lo, hi), np.where(emit, _Z64, lo)
            e_ptr, used = e_ptr + emit, used - 64 * emit
            if laggard and (i + 1) % G == 0:
                base = tile_min()
            upto = warp_min()
            if flush_to_base:
                upto = np.maximum(upto, np.broadcast_to(base, shape)
                                  .reshape(n_tiles, -1, 32).max(axis=2))
            flush(upto)
        if c == len(bounds) - 2:
            bits_out = 64 * e_ptr + used
            retire(used > 0, base if laggard else window_base(nb - 1))
        flush(flushed + _RING)
    return (pay.view(np.int32), bits_out.astype(np.int32),
            dn.astype(np.int32), dx.astype(np.int32), viol.astype(np.int32))


def _a2_chunked(words, enc, *, k, snum, stride_rows, rot, e_band, anchor, G,
                bounds):
    """A2 (`ils_pack_certify`) in `_pack_chunked`: the strided payload of
    (n_tiles + 1) * stride_rows rows, the anchor's window."""
    n_tiles = words.shape[0] // (k // 4)
    laggard = anchor == "laggard"
    cap_pairs = stride_rows // 2
    W = min(e_band + G + (2 if laggard else 0), cap_pairs)
    return _pack_chunked(
        words, enc, k=k, snum=snum, rot=rot, G=G, bounds=bounds, W=W,
        cap_pairs=cap_pairs, boff=-(e_band // 2), laggard=laggard,
        row0=np.arange(n_tiles) * stride_rows,
        n_rows=(n_tiles + 1) * stride_rows, flush_to_base=True)


def _a5_chunked(words, enc, boffs, row_starts, *, k, snum, w_cap, w_band,
                total_rows, rot, bounds, flush_to_base=False):
    """A5 (`ils_pack`) in `_pack_chunked`: the compact payload of
    total_rows + w_cap rows at the row starts, A4's window anchors;
    `flush_to_base` takes A2's flush rule instead of A5's."""
    G = tk.flush_group(k, w_band)
    cap_pairs = w_cap // 2
    return _pack_chunked(
        words, enc, k=k, snum=snum, rot=rot, G=G, bounds=bounds,
        W=min(w_band + G, cap_pairs), cap_pairs=cap_pairs, boff=boffs,
        laggard=False, row0=row_starts, n_rows=total_rows + w_cap,
        flush_to_base=flush_to_base)[0]


def _skewed(k):
    """Stream 5 of all-rare bytes leaves a 2-pair band (the JAX suite's
    violation case)."""
    n = k * ILS_LANES
    data = np.zeros(n, np.uint8)
    rare = np.arange(1, 256, dtype=np.uint8)
    data[::129] = rare[np.arange((n + 128) // 129) % 255]
    u32_idx = np.arange(5, n // 4, ILS_LANES)
    byte_idx = (u32_idx[:, None] * 4 + np.arange(4)[None]).reshape(-1)
    data[byte_idx] = rare[np.arange(byte_idx.size) % 255]
    return data


# (k, data, rot, e_band) at the JAX suite's shapes (tests/test_ils.py)
_A2_CASES = {
    "r=0.5 k=64 rot": lambda: (64, generate_redundant(2 * 64 * ILS_LANES, 0.5,
                                                      seed=31), True, 32),
    "r=0.9 k=12 rot": lambda: (12, generate_redundant(2 * 12 * ILS_LANES, 0.9,
                                                      seed=4), True, 32),
    "zeros|uniform k=256": lambda: (256, _heterogeneous(256), False, 8),
    "skewed k=48": lambda: (48, _skewed(48), False, 2),
}


@functools.lru_cache(maxsize=None)
def _a2_reference(case, anchor):
    """(port data, enc, snum, kw, JAX outputs, plain outputs) of a case."""
    k, data, rot, e_band = _A2_CASES[case]()
    jt, pt, snum, jd, td, ml = _case(data, k)
    kw = dict(k=k, stride_rows=max(2 * (-(-k * ml // 64)), 4), rot=rot,
              e_band=e_band, anchor=anchor)
    ref = jk.ils_pack_certify(jd, _jparams(snum), jk.ils_enc_tabs(jt),
                              interpret=True, **kw)
    enc = tk.ils_enc_tabs(pt, device="cpu")
    plain = tk.ils_pack_certify(td, snum, enc, **kw)
    return td, enc, snum, kw, ref, plain


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("anchor", ["mu", "laggard"])
@pytest.mark.parametrize("case", list(_A2_CASES))
def test_a2_chunk_model_matches_plain_and_jax(case, anchor, C):
    td, enc, snum, kw, ref, plain = _a2_reference(case, anchor)
    G = tk.flush_group(kw["k"], kw["e_band"])
    got = _a2_chunked(td.numpy(), enc.numpy(), snum=snum, G=G,
                      bounds=_chunk_bounds(kw["k"] // 4, G, C), **kw)
    for name, a, b, p in zip(("pay", "bits", "dn", "dx", "viol"), ref, got,
                             plain):
        assert np.array_equal(b, p.numpy()), name
        assert np.array_equal(np.asarray(a).reshape(b.shape), b), name
    if case == "skewed k=48" and anchor == "mu":
        assert got[4].max() == 1


@pytest.mark.parametrize("anchor", ["mu", "laggard"])
def test_a2_chunk_model_whole_windows(anchor):
    # the kernel's geometry at k=2048 (certify_chunks: 2 chunks of 4
    # windows) and one chunk a window, on 2 tiles; bodies 128-255 of tile 0
    # hold only bytes the table lacks (no code bits: the next chunk's seed
    # walks back over them into the bodies before)
    k = 2048
    data = generate_redundant(2 * k * ILS_LANES, 0.5, seed=33)
    data[data >= 200] = 65
    jt = _fit(data)
    data[128 * 4 * ILS_LANES : 256 * 4 * ILS_LANES] = 201
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    snum = ils_schedule_numer(float(jt.lengths.astype(np.int64)[data].mean()))
    td = torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES).copy())
    enc = tk.ils_enc_tabs(pt, device="cpu")
    for rot, e_band in ((False, 32), (True, 8)):
        kw = dict(k=k, stride_rows=max(2 * (-(-k * jt.max_len_present // 64)),
                                       4), rot=rot, e_band=e_band,
                  anchor=anchor)
        plain = tk.ils_pack_certify(td, snum, enc, **kw)
        G = tk.flush_group(k, e_band)
        chunks, chunk_win = tk.certify_chunks(k)
        assert (chunks, chunk_win) == (2, 4)
        for win in (chunk_win, 1):
            bounds = list(range(0, k // 4, 64 * win)) + [k // 4]
            got = _a2_chunked(td.numpy(), enc.numpy(), snum=snum, G=G,
                              bounds=bounds, **kw)
            for name, b, p in zip(("pay", "bits", "dn", "dx", "viol"), got,
                                  plain):
                assert np.array_equal(b, p.numpy()), (name, rot, win)


def _falling(boffs, d=6):
    """Window anchors raised by d in even windows and lowered by d in odd
    ones: the window base falls at every odd window."""
    w = np.arange(boffs.shape[1])
    return (boffs + np.where(w % 2 == 0, d, -d)).astype(np.int32)


@pytest.mark.parametrize("k,r,rot,fall", [
    (12, 0.5, False, False), (12, 0.9, True, False), (64, 0.5, True, False),
    (512, 0.5, False, True), (512, 0.9, True, True),
])
def test_a5_chunk_model_matches_plain_and_jax(k, r, rot, fall):
    # A5 in its chunked compact form at the JAX suite's shapes, and at two
    # windows a stream with anchors that fall between them; chunks of whole
    # flush groups
    data = generate_redundant(2 * k * ILS_LANES, r, seed=4)
    jt, pt, snum, jd, td, _ = _case(data, k)
    bits, dmin, dmax, emin, emax = jk.ils_lengths_pass(
        jd, _jparams(snum), jk.ils_enc_tabs(jt), k=k, rot=rot, interpret=True)
    enc_min = np.asarray(jnp.min(emin, axis=(2, 3)))
    enc_max = np.asarray(jnp.max(emax, axis=(2, 3)))
    w_band = jils.round_band(
        int(np.maximum(enc_max - enc_min, 0).max(initial=0)) + 2)
    w_tiles = np.maximum(2 * (-(-np.asarray(bits).max(axis=(1, 2)) // 64)), 4)
    p = jils.certify_params(
        k=k, snum=snum, n_tiles=2, w_tiles=w_tiles.astype(np.int64),
        dec_min=np.asarray(jnp.min(dmin, axis=(2, 3))),
        dec_max=np.asarray(jnp.max(dmax, axis=(2, 3))),
        extra_band_pairs=w_band, rot=rot)
    boffs = np.where(enc_min <= enc_max, enc_min, 0).astype(np.int32)
    if fall:
        assert boffs.shape[1] == 2
        boffs = _falling(boffs)
    starts = p.row_starts[:-1].astype(np.int32)
    kw = dict(k=k, w_cap=p.w_cap, w_band=w_band, total_rows=p.total_rows,
              rot=rot)
    ref = np.asarray(jk.ils_pack(jd, _jparams(snum), jnp.asarray(boffs),
                                 jnp.asarray(starts), jk.ils_enc_tabs(jt),
                                 interpret=True, **kw))
    enc = tk.ils_enc_tabs(pt, device="cpu")
    plain = tk.ils_pack(td, snum, torch.from_numpy(boffs),
                        torch.from_numpy(starts), enc, **kw).numpy()
    G = tk.flush_group(k, w_band)
    for C in (1, 2, 4):
        got = _a5_chunked(td.numpy(), enc.numpy(), boffs, starts, snum=snum,
                          bounds=_chunk_bounds(k // 4, G, C), **kw)
        assert np.array_equal(got, plain), C
        assert np.array_equal(ref.reshape(-1, ILS_LANES)[: p.total_rows],
                              got[: p.total_rows]), C


# (k, rot, w_band or None for A4's) of A5's kernel geometry: G = 2 where
# the band is at most 192 pairs, else 1
_A5_CASES = {
    "k=2048 G=2": (2048, False, None),
    "k=4096 G=1 rot": (4096, True, 200),
    "k=8192 G=2 rot": (8192, True, None),
    "k=8192 G=1": (8192, False, 200),
}


@functools.lru_cache(maxsize=None)
def _a5_reference(case):
    """(data, enc, snum, anchors, row starts, kw, plain payload) of 2
    tiles: A4's anchors made to fall at every odd window, and the row
    starts moved so that tile 0's first pairs and tile 1's last ones lie
    outside the payload (skipped)."""
    k, rot, w_band = _A5_CASES[case]
    data = generate_redundant(2 * k * ILS_LANES, 0.5, seed=k + rot)
    jt = _fit(data)
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    snum = ils_schedule_numer(float(jt.lengths.astype(np.int64)[data].mean()))
    td = torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES).copy())
    enc = tk.ils_enc_tabs(pt, device="cpu")
    bits, dn, dx, en, ex = tk.ils_lengths_pass(td, snum, enc, k=k, rot=rot)
    band, boffs = tils.emission_band(en, ex)
    p = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                             extra_band_pairs=band)
    w_band = w_band or band
    w_cap = max(p.w_cap, 2 * (w_band + 64))
    starts = p.row_starts[:-1].astype(np.int32) + np.array([-6, 10], np.int32)
    kw = dict(k=k, w_cap=w_cap, w_band=w_band, total_rows=p.total_rows,
              rot=rot)
    boffs = _falling(boffs)
    plain = tk.ils_pack(td, snum, torch.from_numpy(boffs),
                        torch.from_numpy(starts), enc, **kw).numpy()
    return td.numpy(), enc.numpy(), snum, boffs, starts, kw, plain


@pytest.mark.parametrize("case", list(_A5_CASES))
def test_a5_chunk_model_whole_windows(case):
    # the kernel's geometry: 1, 2 and certify_chunks(k) chunks of whole
    # windows; A2's flush rule (up to the window base) loses pairs here,
    # since the base falls
    data, enc, snum, boffs, starts, kw, plain = _a5_reference(case)
    k = kw["k"]
    assert tk.flush_group(k, kw["w_band"]) == int(case.split("G=")[1][0])
    nb, n_win = k // 4, -(-(k // 4) // 64)
    C_k, win_k = tk.certify_chunks(k)
    for C in sorted({1, 2, C_k}):
        win = win_k if C == C_k else -(-n_win // C)
        bounds = list(range(0, nb, 64 * win)) + [nb]
        assert len(bounds) == C + 1
        got = _a5_chunked(data, enc, boffs, starts, snum=snum, bounds=bounds,
                          **kw)
        assert np.array_equal(got, plain), C
    a2_rule = _a5_chunked(data, enc, boffs, starts, snum=snum, bounds=bounds,
                          flush_to_base=True, **kw)
    assert not np.array_equal(a2_rule, plain)


@pytest.mark.parametrize("k,chunks", [(8, 1), (12, 1), (256, 1), (1024, 1),
                                      (2048, 2), (4096, 4), (8192, 8),
                                      (16384, 16)])
def test_certify_chunks_geometry(k, chunks):
    # every k of pick_k (2048-16384), the k=8 tail, the tests' 12, 256 and
    # 1024: C chunks of whole windows, the last possibly shorter, each a
    # flush boundary (G in {1, 2} divides a window's 64 bodies); the 256
    # MiB main section (64 tiles at k=4096) gives every SM of an H100 (132)
    # one block and fills at most its two-block slots in one wave
    C, win = tk.certify_chunks(k)
    n_win = -(-(k // 4) // 64)
    assert C == chunks and (C - 1) * win < n_win <= C * win
    if k == 4096:
        assert 132 < 64 * C <= 2 * 132


# ----------------------------------------------------------------------
# A4 in (tile, chunk) form: a NumPy model of its two kernels
# ----------------------------------------------------------------------
def _lengths_chunked(words, enc, *, k, snum, rot, bounds):
    """A4's two kernels on chunks [bounds[c], bounds[c + 1]) of whole
    windows of every stream: the bits pass (each chunk's code bits but the
    last's), then each chunk from the closed-form state at its start
    (e_ptr = cum >> 6, used = cum & 63), tracking the emission envelope
    alone.  A refill happens exactly where a pair retires, at pptr = 2 +
    e_ptr, so a window's refill envelope is its emission envelope + 2
    before the final flush, and the sentinels where no pair retired.
    Returns (bits, dn, dx, en, ex, chunk bits) as NumPy arrays."""
    nb = k // 4
    n_tiles = words.shape[0] // nb
    n_win = -(-nb // 64)
    assert bounds[0] == 0 and bounds[-1] == nb
    assert all(b % 64 == 0 for b in bounds[:-1])
    x = words.view(np.uint32).reshape(n_tiles, nb, ILS_LANES).astype(np.int64)
    if rot:
        x = np.take_along_axis(x, rot_src_index(k)[None], axis=2)
    lens = enc.astype(np.int64) >> 20
    l4 = sum(lens[(x >> (8 * j)) & 255] for j in range(4))
    cbits = [l4[:, b0:b1].sum(axis=1) for b0, b1 in zip(bounds[:-2],
                                                          bounds[1:-1])]
    big = 1 << 30
    env = np.full((4, n_tiles, n_win, ILS_LANES), big, np.int64)
    env[1::2] = -big  # dn, dx, en, ex
    dn, dx, en, ex = env
    shape = (n_tiles, ILS_LANES)
    for c, (b0, b1) in enumerate(zip(bounds[:-1], bounds[1:])):
        cum = sum(cbits[:c], np.zeros(shape, np.int64))
        used, e_ptr = cum & 63, cum >> 6
        emin, emax = np.full(shape, big), np.full(shape, -big)
        for i in range(b0, b1):
            used = used + l4[:, i]
            emit = used >= 64
            dev = e_ptr - ((i * snum) >> 16)
            emin = np.where(emit, np.minimum(emin, dev), emin)
            emax = np.where(emit, np.maximum(emax, dev), emax)
            e_ptr, used = e_ptr + emit, used - 64 * emit
            wi = i // 64
            if (i + 1) % 64 == 0 and i + 1 < nb or i + 1 == nb:
                dn[:, wi] = np.where(emin == big, big, emin + 2)
                dx[:, wi] = np.where(emax == -big, -big, emax + 2)
                if i + 1 == nb:
                    # the final flush of the partial pair, at the last mu
                    bits = 64 * e_ptr + used
                    dev = e_ptr - ((i * snum) >> 16)
                    emin = np.where(used > 0, np.minimum(emin, dev), emin)
                    emax = np.where(used > 0, np.maximum(emax, dev), emax)
                en[:, wi], ex[:, wi] = emin, emax
                emin, emax = np.full(shape, big), np.full(shape, -big)
    cb = np.stack(cbits, axis=1) if cbits else np.zeros(
        (n_tiles, 0, ILS_LANES), np.int64)
    return tuple(v.astype(np.int32) for v in (bits, dn, dx, en, ex, cb))


def _lacking(k, n_tiles, seed):
    """(data, JAX table) of r=0.5 data whose table lacks bytes >= 200, with
    body rows 64-127 of tile 0 and the last window of the last tile all
    byte 201 (no code bits: windows in which no pair retires, the last one
    with a final flush where the stream has a partial pair)."""
    data = generate_redundant(n_tiles * k * ILS_LANES, 0.5, seed=seed)
    data[data >= 200] = 65
    jt = _fit(data)
    rows = data.view(np.int32).reshape(-1, ILS_LANES)
    nb = k // 4
    rows[64:128] = np.int32(-0x36363637)  # 0xC9C9C9C9: byte 201
    rows[n_tiles * nb - (nb - 1) % 64 - 1:] = np.int32(-0x36363637)
    return data, jt


@pytest.mark.parametrize("k,rot,win", [
    (1000, False, 1), (1000, True, 3), (1000, True, 4), (300, False, 1),
])
def test_a4_chunk_model_matches_plain_and_jax(k, rot, win):
    # chunks of `win` windows, the last shorter (nb % 64 != 0 at both k),
    # windows without a retiring pair, rotation on and off
    data, jt = _lacking(k, 2, seed=k + rot)
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    snum = ils_schedule_numer(float(jt.lengths.astype(np.int64)[data].mean()))
    words = data.view(np.int32).reshape(-1, ILS_LANES).copy()
    enc = tk.ils_enc_tabs(pt, device="cpu")
    ref = jk.ils_lengths_pass(jnp.asarray(words.reshape(-1, 8, 128)),
                              _jparams(snum), jk.ils_enc_tabs(jt), k=k,
                              rot=rot, interpret=True)
    plain = tk.ils_lengths_pass(torch.from_numpy(words), snum, enc, k=k,
                                rot=rot)
    nb = k // 4
    bounds = list(range(0, nb, 64 * win)) + [nb]
    got = _lengths_chunked(words, enc.numpy(), k=k, snum=snum, rot=rot,
                           bounds=bounds)
    for name, a, b, p in zip(("bits", "dn", "dx", "en", "ex"), ref, got,
                             plain):
        assert np.array_equal(b, p.numpy()), name
        assert np.array_equal(np.asarray(a).reshape(b.shape), b), name
    # the sentinels of the empty windows (window 1 of tile 0, the last of
    # tile 1), and the final flush in the last one's emission envelope
    n_win = got[1].shape[1]
    assert (got[1][0, 1] == 1 << 30).all() and (got[1][1, -1] == 1 << 30).all()
    assert (got[3][0, 1] == 1 << 30).all() or n_win == 2
    assert (got[3][1, -1] < 1 << 30).any()


@pytest.mark.parametrize("k,rot", [(2048, False), (1300, True), (8, False)])
def test_a4_chunk_model_kernel_geometry(k, rot):
    # certify_chunks(k): 2 chunks of 4 windows at k=2048, 2 at k=1300 (the
    # last of 2 windows, the last one partial), 1 at the k=8 tail; the
    # wrapper's chunk bits (`chunk_bits=True`) on the CPU are the model's,
    # and A5 given them writes the same payload
    data, jt = _lacking(k, 2, seed=5) if k > 8 else (
        generate_redundant(2 * k * ILS_LANES, 0.5, seed=5), None)
    jt = jt or _fit(data)
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    snum = ils_schedule_numer(float(jt.lengths.astype(np.int64)[data].mean()))
    td = torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES).copy())
    enc = tk.ils_enc_tabs(pt, device="cpu")
    out = tk.ils_lengths_pass(td, snum, enc, k=k, rot=rot, chunk_bits=True)
    C, win = tk.certify_chunks(k)
    nb = k // 4
    bounds = list(range(0, nb, 64 * win)) + [nb]
    assert len(bounds) == C + 1 and C == (2 if k > 8 else 1)
    got = _lengths_chunked(td.numpy(), enc.numpy(), k=k, snum=snum, rot=rot,
                           bounds=bounds)
    for name, a, b in zip(("bits", "dn", "dx", "en", "ex", "cbits"), out,
                          got):
        assert np.array_equal(a.numpy(), b), name
    assert tuple(out[5].shape) == (2, C - 1, ILS_LANES)
    band, boffs = tils.emission_band(out[3], out[4])
    p = tils.envelope_params(*out[:3], k=k, snum=snum, rot=rot,
                             extra_band_pairs=band)
    kw = dict(k=k, w_cap=p.w_cap, w_band=band, total_rows=p.total_rows,
              rot=rot)
    args = (td, snum, torch.from_numpy(boffs), tils.row_starts_of(p, "cpu"),
            enc)
    assert torch.equal(tk.ils_pack(*args, **kw),
                       tk.ils_pack(*args, cbits=out[5], **kw))
    with pytest.raises(ValueError, match="cbits"):
        tk.ils_pack(*args, cbits=out[5][:1], **kw)


def test_compact_matches():
    k, rot = 64, True
    data = generate_redundant(3 * k * ILS_LANES, 0.5, seed=31)
    jt, pt, snum, jd, td, ml = _case(data, k)
    stride_rows = max(2 * (-(-k * ml // 64)), 4)
    pay, bits, dn, dx, viol = jk.ils_pack_certify(
        jd, _jparams(snum), jk.ils_enc_tabs(jt), k=k, stride_rows=stride_rows,
        rot=rot, interpret=True)
    assert int(jnp.max(viol)) == 0
    w_tiles = np.maximum(2 * (-(-np.asarray(bits).max(axis=(1, 2)) // 64)), 4)
    p = jils.certify_params(
        k=k, snum=snum, n_tiles=3, w_tiles=w_tiles.astype(np.int64),
        dec_min=np.asarray(jnp.min(dn, axis=(2, 3))),
        dec_max=np.asarray(jnp.max(dx, axis=(2, 3))), rot=rot)
    starts = p.row_starts[:-1].astype(np.int32)
    kw = dict(stride_rows=stride_rows, w_cap=p.w_cap, total_rows=p.total_rows)
    ref = jk.ils_compact(pay, jnp.asarray(starts), interpret=True, **kw)
    pay_t = torch.from_numpy(np.asarray(pay).reshape(-1, ILS_LANES).copy())
    got = tk.ils_compact(pay_t, torch.from_numpy(starts), **kw)
    # the TPU kernel writes w_cap rows from the last tile's start (its real
    # rows, then zeros over-read from the strided slack); rows past that
    # are never written there and are zero here
    written = int(starts[-1]) + p.w_cap
    assert _eq(np.asarray(ref).reshape(-1, ILS_LANES)[:written], got[:written])
    assert not got[p.total_rows:].any()


@pytest.mark.parametrize("r,rot", [(0.5, False), (0.5, True), (0.9, True),
                                   (0.0, False)])
def test_decode_matches_jax_sections(r, rot):
    # sections written by the JAX encoder, decoded by both decoders
    k = 12
    data = generate_redundant(2 * k * ILS_LANES, r, seed=4)
    jt = _fit(data)
    avg = float(jt.lengths.astype(np.int64)[data].mean())
    jd = jk.ils_dec_tabs(jt)
    sec = jils.ils_encode_device(data, jt, jk.ils_enc_tabs(jt), k=k,
                                 avg_bits=avg, rot=rot, interpret=True)
    p = sec.params
    ref = jils.ils_decode_device(sec, jt, jd, interpret=True)
    ps = section_from_numpy(p.k, p.snum, p.boffs, p.w_band, p.w_cap,
                            p.w_tiles, p.n_tiles, p.rot, sec.payload)
    pt = code_table_from_numpy(jt.lengths, jt.max_len)
    starts = torch.from_numpy(p.row_starts[:-1].astype(np.int32))
    kw = dict(k=k, w_cap=p.w_cap, n_tiles=p.n_tiles,
              max_len=pt.max_len_present, min_len=pt.min_len, rot=p.rot)
    # rows past the payload read as zeros: no slack rows are needed, and
    # appending the JAX decoder's w_cap zero rows changes nothing
    got = tk.ils_decode(ps.payload, starts, tk.ils_dec_tabs(pt, device="cpu"), **kw)
    slack = torch.zeros(p.w_cap, ILS_LANES, dtype=torch.int32)
    padded = tk.ils_decode(torch.cat([ps.payload, slack]), starts,
                           tk.ils_dec_tabs(pt, device="cpu"), **kw)
    assert np.array_equal(got.numpy().view(np.uint8).reshape(-1), ref)
    assert torch.equal(got, padded)
    assert np.array_equal(ref, data)


def _lut_table(kind):
    """Port code tables for A1's length-and-symbol table: every length
    1..16 (skew16), one symbol (min_len = max_len = 1), 256 8-bit codes,
    and fitted r=0.9 / r=0.5 tables."""
    if kind == "skew16":
        lengths = np.zeros(256, np.uint8)
        lengths[40:57] = np.r_[np.arange(1, 16), 16, 16]
        return code_table_from_numpy(lengths, 16)
    data = {"single": np.full(4096, 9, np.uint8),
            "uniform": np.arange(4096, dtype=np.uint8)}.get(kind)
    if data is None:
        data = generate_redundant(1 << 16, float(kind), seed=8)
    jt = _fit(data)
    return code_table_from_numpy(jt.lengths, jt.max_len)


def _chain(table, win):
    """The compare chain of the plain decode (`canon_len` -> bias ->
    symtab) on u32 windows (int64): (length, symbol)."""
    dec = tk.ils_dec_tabs(table, device="cpu")
    lim = dec.lim.numpy().astype(np.int64) & 0xFFFFFFFF
    bias, symtab = dec.bias.numpy().astype(np.int64), dec.symtab.numpy()
    lo, hi = max(table.min_len, 1), max(table.max_len_present, 1)
    ln = lo + sum(((win >= lim[lv]).astype(np.int64) for lv in range(lo, hi)),
                  np.zeros_like(win))
    return ln, symtab[(bias[ln] + (win >> (32 - ln))) & 255]


@pytest.mark.parametrize("bits", [1, 8, 10, 11, 12])
@pytest.mark.parametrize("kind", ["skew16", "single", "uniform", "0.9", "0.5"])
def test_decode_lut_matches_compare_chain(kind, bits):
    # every B-bit prefix: an entry (len << 8) | symbol must be the chain's
    # answer for every window with that prefix (its lowest, its highest and
    # 16 random ones); an empty entry is a prefix the chain does not decide
    # within B bits
    table = _lut_table(kind)
    lut = tk.ils_decode_lut(tk.ils_dec_tabs(table, device="cpu"),
                            max_len=max(table.max_len_present, 1),
                            min_len=table.min_len, bits=bits).numpy()
    assert lut.shape == (1 << bits,)
    x = np.arange(1 << bits, dtype=np.int64)
    span = (1 << (32 - bits)) - 1
    rng = np.random.default_rng(bits)
    low = x << (32 - bits)
    fills = [0, span] + list(rng.integers(0, span + 1, 16))
    got = [_chain(table, low | f) for f in fills]
    full = lut != 0
    for ln, sym in got:
        assert np.array_equal(lut[full] >> 8, ln[full])
        assert np.array_equal(lut[full] & 255, sym[full])
    ln0, ln1 = got[0][0], got[1][0]
    assert np.array_equal(~full, (ln0 > bits) | (ln0 != ln1))
    # where every code fits in B bits the table covers every window
    if table.max_len_present <= bits:
        assert full.all()
    if kind == "single":
        # the 1-bit code 0 is symbol 9; a window from 1 reads rank 1, the
        # zero padding of symtab, as the chain does
        assert np.array_equal(lut, (1 << 8) | np.where(x >> (bits - 1), 0, 9))


def test_wrappers_route_cpu_to_plain_and_check_inputs():
    k = 12
    data = generate_redundant(2 * k * ILS_LANES, 0.5, seed=4)
    _, pt, snum, _, td, _ = _case(data, k)
    tk.reset_launch_counts()
    tk.ils_lengths_pass(td, snum, tk.ils_enc_tabs(pt, device="cpu"), k=k)
    assert tk.launch_counts() == dict.fromkeys(tk.launch_counts(), 0)
    with pytest.raises(ValueError, match="tensors on"):
        tk.ils_lengths_pass(td, snum, tk.ils_enc_tabs(pt, device="cpu").to("meta"), k=k)
    with pytest.raises(ValueError, match="data must be"):
        tk.ils_lengths_pass(td[:5], snum, tk.ils_enc_tabs(pt, device="cpu"), k=k)
    # row offsets of the wrong type or count are refused; their values are
    # taken on trust (no device-to-host sync), and the kernels keep every
    # row they address inside their buffers
    boffs = torch.zeros((2, 1), dtype=torch.int32)
    for starts, err in ((torch.tensor([0, 8]), TypeError),
                        (torch.tensor([0], dtype=torch.int32), ValueError)):
        with pytest.raises(err, match="row_starts"):
            tk.ils_pack(td, snum, boffs, starts, tk.ils_enc_tabs(pt, device="cpu"), k=k,
                        w_cap=16, w_band=8, total_rows=8)
        with pytest.raises(err, match="row_starts"):
            tk.ils_decode(torch.zeros((24, ILS_LANES), dtype=torch.int32),
                          starts, tk.ils_dec_tabs(pt, device="cpu"), k=k, w_cap=16,
                          n_tiles=2, max_len=pt.max_len_present)
    with pytest.raises(TypeError, match="row_starts"):
        tk.ils_compact(torch.zeros((18, ILS_LANES), dtype=torch.int32),
                       torch.tensor([0, 8]), stride_rows=6, w_cap=16,
                       total_rows=12)
    # a pair the compact payload cannot hold is skipped, as in the kernel
    starts = torch.tensor([0, 40], dtype=torch.int32)
    got = tk.ils_pack(td, snum, boffs, starts, tk.ils_enc_tabs(pt, device="cpu"), k=k,
                      w_cap=16, w_band=8, total_rows=8)
    assert got.shape == (24, ILS_LANES)
