"""The HTC1 kernels' plain versions against the JAX package, on the CPU.

B1 (`gap_decode_ranks`) against `decode_ranks_pallas` in interpret mode,
a NumPy model of C1's count-table walk (`count_segments`) against the
plain version and `count_segments_pallas` in interpret mode,
B2 (`gap_place_bytes`) against a NumPy ragged concatenation, B4b-B4d and
`encode_blocks` against `encode_blocks_pallas` in interpret mode, the
JAX `encode_block` and the NumPy oracles, and the port's `encode_block`
against the JAX one.  Inputs come from NumPy with a seed; every value is
an integer, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.core import canonical_code_table as jcct
from huffman_tpu.core.canonical import build_flat_lut as jbuild_flat_lut
from huffman_tpu.core import npref as jnpref
from huffman_tpu.core import package_merge_lengths as jpml
from huffman_tpu.ops import dec_spec as jdec_spec
from huffman_tpu.ops import device_dec_table as jdevice_dec_table
from huffman_tpu.ops import device_enc_table as jdevice_enc_table
from huffman_tpu.ops.encode import encode_block as jencode_block
from huffman_tpu.io.yamamoto import (
    table_from_length_sequence as jtable_from_length_sequence,
)
from huffman_tpu.ops.pallas.decode_kernel import (
    count_segments_pallas,
    decode_ranks_pallas,
)
from huffman_tpu.ops.pallas.gap_encode_kernel import encode_blocks_pallas
from huffman_tpu.ops.pallas.ils_kernels import ils_enc_tabs as jils_enc_tabs
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch.core import npref
from huffman_tpu_torch.core.canonical import build_flat_lut, canonical_code_table
from huffman_tpu_torch.io.yamamoto import table_from_length_sequence
from huffman_tpu_torch.ops import encode as tenc
from huffman_tpu_torch.ops import gap_decode_kernels as gd
from huffman_tpu_torch.ops import gap_encode_kernels as ge
from huffman_tpu_torch.ops import tables as tt
from huffman_tpu_torch.ops.ils_kernels import ils_enc_tabs


def _tables(data, max_len=16):
    jt = jcct(jpml(jnpref.histogram(data), max_len), max_len)
    return jt, canonical_code_table(jt.lengths, max_len)


def _input(kind, n, seed):
    if kind == "single":
        return np.full(n, 7, np.uint8)
    if kind == "uniform":
        return np.arange(n, dtype=np.uint8)
    return generate_redundant(n, float(kind), seed=seed)


def _t(x, dtype=np.int32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(dtype)))


# ----------------------------------------------------------------------
# Tables and oracles
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["0.1", "0.5", "0.9", "single", "uniform"])
def test_tables_and_spec_match(kind):
    data = _input(kind, 5000, 1)
    jt, pt = _tables(data)
    assert tt.dec_spec(pt).__dict__ == jdec_spec(jt).__dict__
    # the encoder's one table holds the JAX package's (code, length) pair
    jenc, penc = jdevice_enc_table(jt), ils_enc_tabs(pt, device="cpu").numpy()
    assert np.array_equal(penc >> 20, np.asarray(jenc.lengths))
    assert np.array_equal(penc & 0xFFFF, np.asarray(jenc.codes))
    jdec = jdevice_dec_table(jt, two_level=False)
    pdec = tt.device_dec_table(pt, device="cpu")
    for f in ("lim_left", "offsets", "first_code", "symtab"):
        assert np.array_equal(getattr(pdec, f).numpy(),
                              np.asarray(getattr(jdec, f))), f
    lim, bias = gd.kernel_tabs(pdec)
    n = jt.lim_left.shape[0]
    assert np.array_equal(lim.numpy().view(np.uint32)[:n], jt.lim_left)
    assert np.array_equal(
        bias.numpy()[:n],
        np.asarray(jdec.offsets) - np.asarray(jdec.first_code).astype(np.int32))
    for a, b in zip(build_flat_lut(pt), jbuild_flat_lut(jt)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seg_bits", [128, 1024])
def test_npref_oracles_match(seg_bits):
    data = generate_redundant(3000, 0.6, seed=2)
    jt, pt = _tables(data)
    w, tb = npref.encode_bits(data, pt)
    jw, jtb = jnpref.encode_bits(data, jt)
    assert tb == jtb and np.array_equal(w, jw)
    meta = npref.segment_metadata(data, pt, seg_bits)
    for a, b in zip(meta, jnpref.segment_metadata(data, jt, seg_bits)):
        assert np.array_equal(a, b)
    gaps, counts, _ = meta
    out = npref.decode_segments_np(w, gaps, counts, pt, seg_bits)
    assert np.array_equal(out, data)
    assert np.array_equal(npref.decode_bits_serial(w, tb, pt, data.size), data)
    assert np.array_equal(npref.histogram(data), jnpref.histogram(data))


# ----------------------------------------------------------------------
# B1: segment ranks
# ----------------------------------------------------------------------
def _ranks_case(data, pt, seg_bits):
    words, _ = npref.encode_bits(data, pt)
    gaps, counts, _ = npref.segment_metadata(data, pt, seg_bits)
    return words, gaps.astype(np.int32), counts


def _port_ranks(words, gaps, counts, pt, seg_bits, max_count):
    spec = tt.dec_spec(pt)
    lim, bias = gd.kernel_tabs(tt.device_dec_table(pt, device="cpu"))
    return gd.gap_decode_ranks(
        _t(words.view(np.int32))[None], _t(gaps)[None], _t(counts)[None], lim,
        bias, seg_bits=seg_bits, max_count=max_count, min_len=spec.min_len,
        max_len=spec.max_len).numpy()


@pytest.mark.parametrize("kind,n,seg_bits", [
    ("0.1", 3000, 1024), ("0.5", 6000, 1024), ("0.9", 6000, 128),
    ("single", 1500, 128), ("uniform", 3000, 1024),
])
def test_decode_ranks_match_jax(kind, n, seg_bits):
    data = _input(kind, n, 3)
    jt, pt = _tables(data)
    words, gaps, counts = _ranks_case(data, pt, seg_bits)
    ns = gaps.size
    mc = int(counts.max())
    packed = np.asarray(decode_ranks_pallas(
        jnp.asarray(words), jnp.asarray(gaps), jnp.asarray(counts),
        jdevice_dec_table(jt, two_level=False), spec=jdec_spec(jt),
        seg_bits=seg_bits, n_segs=ns, max_count=mc, interpret=True))
    # 4 ranks per int32, LSB first: rank i of segment s is byte i % 4 of
    # packed[i // 4, s]
    jr = (packed.view(np.uint8).reshape(packed.shape[0], -1, 4)
          .transpose(1, 0, 2).reshape(packed.shape[1], -1))
    pr = _port_ranks(words, gaps, counts, pt, seg_bits, mc + 5)
    assert pr.shape == (ns, mc + 5)
    for s in range(ns):
        assert np.array_equal(pr[s, : counts[s]], jr[s, : counts[s]]), s
        assert not pr[s, counts[s]:].any()
    rank_of = np.zeros(256, np.int64)
    rank_of[pt.symtab] = np.arange(pt.num_symbols)
    assert np.array_equal(
        np.concatenate([pr[s, : counts[s]] for s in range(ns)]),
        rank_of[data] & 255)


def test_decode_ranks_blocks_read_zeros_past_words():
    # two blocks, the second shorter: its segments read zeros past its
    # words, never the neighbour's; a corrupt count is clamped
    d0 = generate_redundant(2000, 0.5, seed=4)
    d1 = generate_redundant(700, 0.5, seed=5)
    _, pt = _tables(np.concatenate([d0, d1]))
    cases = [_ranks_case(d, pt, 256) for d in (d0, d1)]
    ns = max(c[1].size for c in cases)
    nw = max(c[0].size for c in cases)
    words = np.zeros((2, nw), np.uint32)
    gaps = np.zeros((2, ns), np.int32)
    counts = np.zeros((2, ns), np.int32)
    for g, (w, gp, c) in enumerate(cases):
        words[g, : w.size] = w
        gaps[g, : gp.size] = gp
        counts[g, : c.size] = c
    words[1, cases[1][0].size:] = 0xFFFFFFFF  # past block 1's payload
    spec = tt.dec_spec(pt)
    lim, bias = gd.kernel_tabs(tt.device_dec_table(pt, device="cpu"))
    mc = int(counts.max())
    kw = dict(seg_bits=256, max_count=mc, min_len=spec.min_len,
              max_len=spec.max_len)
    full = gd.gap_decode_ranks(_t(words.view(np.int32)), _t(gaps), _t(counts),
                               lim, bias, **kw).numpy()
    n1 = cases[1][0].size
    cut = gd.gap_decode_ranks(
        _t(words[:, :n1].view(np.int32)), _t(gaps), _t(counts), lim, bias,
        **kw).numpy()
    # block 1's real symbols never reach past its own words
    assert np.array_equal(cut[ns:], full[ns:])
    bad = counts.copy()
    bad[0, 0] = mc + 100
    clamped = gd.gap_decode_ranks(
        _t(words.view(np.int32)), _t(gaps), _t(bad), lim, bias, **kw).numpy()
    assert np.array_equal(clamped[1:], full[1:])
    assert np.array_equal(clamped[0, : counts[0, 0]], full[0, : counts[0, 0]])


# ----------------------------------------------------------------------
# B2: ragged placement
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_segs,max_count,seed", [(7, 16, 4), (200, 256, 2),
                                                   (50, 1100, 3)])
def test_place_bytes_matches_numpy_concat(n_segs, max_count, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count + 1, n_segs).astype(np.int32)
    counts[rng.random(n_segs) < 0.1] = 0
    ranks = rng.integers(0, 256, (n_segs, max_count)).astype(np.uint8)
    symtab = rng.permutation(256).astype(np.int32)
    expect = symtab[np.concatenate(
        [ranks[s, : counts[s]] for s in range(n_segs)])].astype(np.uint8)
    offsets = np.cumsum(counts, dtype=np.int64) - counts
    out = gd.gap_place_bytes(torch.from_numpy(ranks), _t(counts),
                             _t(offsets, np.int64), _t(symtab),
                             n_out=expect.size)
    assert np.array_equal(out.numpy(), expect)
    # writes past n_out are dropped, not wrapped
    short = gd.gap_place_bytes(torch.from_numpy(ranks), _t(counts),
                               _t(offsets, np.int64), _t(symtab),
                               n_out=expect.size // 2)
    assert np.array_equal(short.numpy(), expect[: expect.size // 2])


def _b2_runs(ranks, counts, offsets, symtab, n_out):
    """A NumPy model of csrc/gap_decode.cu's B2: blocks of `place_tile`'s
    R rows (one row in column chunks where a row is wider than the tile);
    a run whose rows' offsets follow the prefix sum of their clamped
    counts is one output range, cut to [0, n_out); another run is placed
    row by row."""
    n_segs, mc = ranks.shape
    rows, chunk, _ = gd.place_tile(mc)
    sym = symtab.astype(np.uint8)
    out = np.zeros(n_out, np.uint8)

    def put(d, vals):
        ok = (d >= 0) & (d < n_out)
        out[d[ok]] = vals[ok]

    for s0 in range(0, n_segs, rows):
        nv = min(rows, n_segs - s0)
        n = np.clip(counts[s0 : s0 + nv].astype(np.int64), 0, mc)
        off = offsets[s0 : s0 + nv]
        for lo in range(0, mc, chunk):
            m = np.clip(n - lo, 0, chunk)
            pre = np.cumsum(m) - m
            d0 = off[0] + lo
            if not np.all((m == 0) | (off + lo == d0 + pre)):
                for r in range(nv):
                    put(off[r] + lo + np.arange(m[r]),
                        sym[ranks[s0 + r, lo : lo + m[r]]])
                continue
            # rows at stride mc (chunk == mc unless nv == 1), cut after the
            # last row's bytes
            q = np.arange((nv - 1) * mc + m[-1])
            flat = ranks[s0 : s0 + nv].reshape(-1)[lo : lo + q.size]
            keep = q % mc < m[q // mc]
            put(d0 + np.arange(m.sum()), sym[flat[keep]])
    return out


@pytest.mark.parametrize("max_count,n_segs", [(1, 2100), (48, 1500),
                                              (256, 300), (1100, 70),
                                              (8193, 7), (65505, 3)])
def test_place_bytes_run_model_matches_plain(max_count, n_segs):
    # the kernel's runs on real prefix offsets, n_out cut short, zero
    # counts, a count above max_count (clamped: a gap in the offsets) and
    # offsets that start before the output
    rng = np.random.default_rng(max_count)
    counts = rng.integers(max_count // 3, max_count + 1, n_segs)
    counts[rng.random(n_segs) < 0.2] = 0
    ranks = rng.integers(0, 256, (n_segs, max_count)).astype(np.uint8)
    symtab = rng.permutation(256).astype(np.int32)
    over = counts.copy()
    over[n_segs // 2] = max_count + 7
    offs = {name: np.cumsum(c, dtype=np.int64) - c
            for name, c in (("real", counts), ("over", over))}
    n = int(counts.sum())
    for c, o, n_out in ((counts, offs["real"], n),
                        (counts, offs["real"], n // 2 + 3),
                        (over, offs["over"], int(over.sum())),
                        (counts, offs["real"] - 777, n)):
        ref = gd.gap_place_bytes_plain(torch.from_numpy(ranks), _t(c),
                                       _t(o, np.int64), _t(symtab),
                                       n_out=n_out).numpy()
        assert np.array_equal(_b2_runs(ranks, c, o, symtab, n_out), ref)


@pytest.mark.parametrize("max_count,rows,chunk", [
    (1, 1024, 1), (48, 682, 48), (256, 128, 256), (1100, 29, 1100),
    (8193, 3, 8193),
    # seg_bits=65504 with 1-bit codes: one row in column chunks
    (65505, 1, 32768),
])
def test_place_tile_geometry(max_count, rows, chunk):
    # R whole rows of at most PLACE_TILE bytes (at most 4 a thread for the
    # scan), or one row in column chunks; the buffer holds a run's bytes
    # at the output's phase mod 16, then two ints a row and two more
    r, c, smem = gd.place_tile(max_count)
    assert (r, c) == (rows, chunk)
    assert r * c <= gd.PLACE_TILE and r <= 4 * 256
    assert r == 1 or c == max_count
    # whole 16-byte units from a phase of up to 15 bytes
    buf = smem - 8 * (r + 1)
    assert buf % 16 == 0 and buf >= 16 * -(-(r * c + 15) // 16)
    # beside the kernel's static shared memory (under 1 KB)
    assert smem + 1024 <= SMEM_PER_BLOCK


# ----------------------------------------------------------------------
# B4b-B4d and encode_blocks
# ----------------------------------------------------------------------
def _jax_encode(blocks, jt, seg_bits, max_words, n_segs):
    enc = jdevice_enc_table(jt)
    ref = jax.vmap(lambda d: jencode_block(
        d, enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs))(
        jnp.asarray(blocks))
    pallas = encode_blocks_pallas(
        jnp.asarray(blocks), jils_enc_tabs(jt), seg_bits=seg_bits,
        max_words=max_words, n_segs=n_segs, min_len=max(jt.min_len, 1),
        max_len=jt.max_len_present, interpret=True)
    return [np.asarray(x) for x in ref], [np.asarray(x) for x in pallas]


@pytest.mark.parametrize("kind,n,g,seg_bits,max_len", [
    ("0.1", 4096, 1, 1024, 16),
    ("0.5", 4096, 1, 1024, 16),
    ("0.9", 4096, 1, 1024, 16),
    ("0.5", 3 * 2048, 3, 1024, 16),
    ("single", 4096, 1, 1024, 16),
    ("uniform", 2048, 2, 128, 16),
    ("0.6", 4096, 1, 128, 16),
    ("0.7", 4096, 1, 1024, 8),
])
def test_encode_blocks_match_jax(kind, n, g, seg_bits, max_len):
    data = _input(kind, n, 6)
    jt, pt = _tables(data, max_len)
    blocks = data.reshape(g, -1)
    lens = pt.lengths.astype(np.int64)
    max_bits = int(lens[blocks].sum(1).max())
    max_words = -(-(-(-max_bits // 32)) // 512) * 512
    n_segs = -(-max_words * 32 // seg_bits)
    ref, pallas = _jax_encode(blocks, jt, seg_bits, max_words, n_segs)
    out = ge.encode_blocks(torch.from_numpy(blocks.copy()),
                           ils_enc_tabs(pt, device="cpu"),
                           seg_bits=seg_bits, max_words=max_words,
                           n_segs=n_segs, max_len=pt.max_len_present)
    names = ("words", "total_bits", "gaps", "counts")
    for name, a, r, p in zip(names, out, ref, pallas):
        a = a.numpy()
        if name == "words":
            a = a.view(np.uint32)
        assert a.shape == r.shape == p.shape, name
        assert np.array_equal(a, r), name
        assert np.array_equal(a, p), name
    # the port's encode_block, one block at a time, gives the same
    for i in range(g):
        single = tenc.encode_block(torch.from_numpy(blocks[i].copy()),
                                   ils_enc_tabs(pt, device="cpu"),
                                   seg_bits=seg_bits, max_words=max_words,
                                   n_segs=n_segs)
        for name, a, r in zip(names, single, ref):
            assert np.array_equal(
                a.numpy().view(np.uint32) if name == "words" else a.numpy(),
                r[i]), name


@pytest.mark.parametrize("kind,n,seg_bits", [
    ("0.5", 1000, 1024), ("0.2", 777, 128), ("single", 300, 128),
    ("uniform", 513, 1024),
])
def test_encode_block_matches_jax(kind, n, seg_bits):
    # the route of blocks whose size is not a multiple of 128 bytes
    data = _input(kind, n, 7)
    jt, pt = _tables(data)
    max_words = 1024
    n_segs = max_words * 32 // seg_bits
    ref = jencode_block(jnp.asarray(data), jdevice_enc_table(jt),
                        seg_bits=seg_bits, max_words=max_words, n_segs=n_segs)
    out = tenc.encode_block(torch.from_numpy(data.copy()),
                            ils_enc_tabs(pt, device="cpu"),
                            seg_bits=seg_bits, max_words=max_words,
                            n_segs=n_segs)
    assert out[0].dtype == torch.int32
    assert np.array_equal(out[0].numpy().view(np.uint32), np.asarray(ref[0]))
    for a, r in zip(out[1:], ref[1:]):
        assert a.dtype == torch.int32 and np.array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("kind", ["0.3", "0.9", "single", "uniform"])
def test_row_pack_meta_place_match_oracle(kind):
    data = _input(kind, 8 * 128, 8)
    _, pt = _tables(data)
    rows = torch.from_numpy(data.copy()).view(torch.int32).view(-1, 32)
    cap = ge.row_cap_words(pt.max_len_present)
    enc = ils_enc_tabs(pt, device="cpu")
    pay, bits = ge.gap_row_pack(rows, enc, cap_words=cap)
    # the starts B4c derives (not stored since B4b stopped writing them)
    starts = ge.row_starts(rows, enc)
    lens = pt.lengths.astype(np.int64)
    for r in range(8):
        row = data[128 * r : 128 * (r + 1)]
        w, tb = npref.encode_bits(row, pt)
        assert int(bits[r]) == tb
        nw = -(-tb // 32)
        assert np.array_equal(pay[r, :nw].numpy().view(np.uint32), w[:nw])
        assert not pay[r, nw:].any()
        ends = np.cumsum(lens[row])
        assert np.array_equal(starts[r].numpy(), ends - lens[row])
    # two blocks of four rows each
    bits_blk = bits.view(2, 4).to(torch.int64)
    s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
    counts, firsts = ge.gap_row_meta(rows, enc, s_local, rows_per_block=4,
                                     n_segs=40, seg_bits=128)
    words = ge.gap_place_bits(pay, bits, s_local, rows_per_block=4,
                              out_words=300)
    for g in range(2):
        blk = data[512 * g : 512 * (g + 1)]
        w, tb = npref.encode_bits(blk, pt)
        assert np.array_equal(words[g, : w.size - 1].numpy().view(np.uint32),
                              w[:-1])
        assert not words[g, w.size - 1 :].any()
        gaps, cnt, _ = npref.segment_metadata(blk, pt, 128)
        ns = gaps.size
        assert np.array_equal(counts[g, :ns].numpy(), cnt)
        assert not counts[g, ns:].any()
        have = cnt > 0
        bounds = np.arange(ns) * 128
        assert np.array_equal(firsts[g, :ns].numpy()[have],
                              (bounds + gaps)[have])
        assert (firsts[g, ns:].numpy() == 2**31 - 1).all()


_I32_MAX = 2**31 - 1


def _b4c_tiles(data_rows, lens, s_local, rows_per_block, n_segs, seg_bits,
               max_len, tile_rows=None, seed=0, n_bytes=None):
    """A NumPy model of csrc/gap_encode.cu's B4c: tiles of `meta_tile`'s R
    rows (or `tile_rows`) of one HTC1 block each, taken in a random order;
    8 lanes a row, 16 symbols a lane, a lane's head past one segment
    boundary counted in closed form; a run of starts in one segment is
    added once, by the lane that holds its head, with the distance to the
    next head (a suffix minimum over the lanes above); runs go to the
    tile's window of segments, or straight to the block's metadata outside
    it, or are dropped outside [0, n_segs).  Then segments strictly inside
    (base, hi) are assigned (a plain store: a neighbour's count there would
    be lost) and the rest of the window is added (the atomics).  With byte
    counts (`n_bytes`, one a block) a tile takes only its rows that hold
    symbols, the last of them ending at its block's count: a lane holds
    the symbols before that end, a lane without any has no head, the last
    run of a row ends there and hi is the segment of the tile's last
    symbol (base where the tile has none)."""
    n_rows = data_rows.shape[0]
    g_n = n_rows // rows_per_block
    shift = seg_bits.bit_length() - 1
    rows, window, _ = ge.meta_tile(seg_bits, max_len)
    if tile_rows is not None:
        rows = tile_rows
        window = -(-rows * 128 * max_len // seg_bits) + 1
    counts = np.zeros((g_n, n_segs), np.int64)
    firsts = np.full((g_n, n_segs), _I32_MAX, np.int64)
    tiles = [(g, t0) for g in range(g_n) for t0 in range(0, rows_per_block, rows)]
    np.random.default_rng(seed).shuffle(tiles)
    for g, t0 in tiles:
        nv = min(rows, rows_per_block - t0)
        last_bytes = 128
        if n_bytes is not None:
            rest = int(n_bytes[g]) - t0 * 128
            nv = min(nv, -(-rest // 128) if rest > 0 else 0)
            if nv:
                last_bytes = min(rest - (nv - 1) * 128, 128)
        r0 = g * rows_per_block + t0
        base = int(s_local[r0]) >> shift
        hi = base
        cnt_s = np.zeros(window, np.int64)
        fst_s = np.full(window, _I32_MAX, np.int64)

        def put(seg, n, first):
            w = seg - base
            if 0 <= w < window:
                cnt_s[w] += n
                fst_s[w] = min(fst_s[w], first)
            elif 0 <= seg < n_segs:
                counts[g, seg] += n
                firsts[g, seg] = min(firsts[g, seg], first)

        for r in range(r0, r0 + nv):
            row_end = last_bytes if r == r0 + nv - 1 else 128
            ln = np.where(np.arange(128) < row_end, lens[data_rows[r]], 0)
            a = int(s_local[r]) + np.cumsum(ln) - ln
            seg = a >> shift
            heads = []  # per lane: its head positions
            for lane in range(8):
                q = np.arange(16 * lane, min(16 * lane + 16, row_end))
                if q.size == 0:
                    heads.append([])
                    continue
                seg0, seg_last = int(seg[q[0]]), int(seg[q[-1]])
                head0 = lane == 0 or seg0 != seg[q[0] - 1]
                if seg_last - seg0 <= 1:
                    # one boundary at most: its head counted in closed form
                    h = [q[0]] if head0 else []
                    if seg_last != seg0:
                        to_bound = ((seg0 + 1) << shift) - int(a[q[0]])
                        x = a[q] - a[q[0]]
                        h.append(q[0] + int((x < to_bound).sum()))
                else:
                    h = [p for p in q if (p == q[0] and head0)
                         or (p != q[0] and seg[p] != seg[p - 1])]
                heads.append(h)
            first_head = [h[0] if h else row_end for h in heads]
            for lane in range(8):
                nxt = min(first_head[lane + 1:], default=row_end)
                ends = heads[lane][1:] + [nxt]
                for p, e in zip(heads[lane], ends):
                    put(int(seg[p]), e - p, int(a[p]))
            if r == r0 + nv - 1:
                hi = int(seg[row_end - 1])
        for j in range(window):
            sg = base + j
            if not 0 <= sg < n_segs:
                continue
            if j > 0 and sg < hi:
                counts[g, sg] = cnt_s[j]
                firsts[g, sg] = fst_s[j]
            elif cnt_s[j]:
                counts[g, sg] += cnt_s[j]
                firsts[g, sg] = min(firsts[g, sg], fst_s[j])
    return counts, firsts


def _lacking_table(data):
    """The table of `data` with bytes >= 200 replaced: those bytes have
    length 0 in it."""
    return _tables(np.where(data >= 200, 65, data).astype(np.uint8))


@pytest.mark.parametrize("case", [
    # (kind, blocks, bytes a block, seg_bits, n_segs cut, tile rows)
    ("0.5", 2, 4096, 1024, None, None),
    ("0.5", 2, 4096, 8, None, None),      # R = 16: tiles cut each block
    ("0.3", 3, 2560, 8, None, None),      # 20 rows: tiles of 16 and 4
    ("0.5", 1, 8192, 8192, None, None),
    ("0.9", 2, 4096, 128, 9, None),       # n_segs cut short
    ("lacks", 2, 4096, 128, None, 3),     # length-0 bytes, tiles of 3 rows
    ("single", 2, 2048, 8, None, 1),      # 1-bit codes, a tile a row
    ("0.5", 1, 4096, 64, None, 5),        # 5 rows: tiles cut mid-segment
])
def test_b4c_tile_model_matches_plain_and_jax(case):
    kind, g, b, seg_bits, cut, tile_rows = case
    data = _input("0.5" if kind == "lacks" else kind, g * b, 9)
    if kind == "lacks":
        data[::37] = 200 + np.arange(data[::37].size) % 56
        data[128:256] = 201  # a row of 0 bits: 128 starts at one bit
        jt, pt = _lacking_table(data)
    else:
        jt, pt = _tables(data)
    lens = pt.lengths.astype(np.int64)
    enc = ils_enc_tabs(pt, device="cpu")
    rows = torch.from_numpy(data.copy()).view(torch.int32).view(-1, 32)
    max_len = max(pt.max_len_present, 1)
    pay, bits = ge.gap_row_pack(rows, enc, cap_words=ge.row_cap_words(max_len))
    bits_blk = bits.view(g, -1).to(torch.int64)
    s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
    total = bits_blk.sum(1).numpy()
    max_words = -(-(-(-int(total.max()) // 32)) // 512) * 512
    n_segs = cut or -(-max_words * 32 // seg_bits)
    kw = dict(rows_per_block=b // 128, n_segs=n_segs, seg_bits=seg_bits)
    ref = ge.gap_row_meta_plain(rows, enc, s_local, **kw)
    model = _b4c_tiles(data.reshape(-1, 128), lens, s_local.numpy(),
                       max_len=max_len, tile_rows=tile_rows, **kw)
    for a, r in zip(model, ref):
        assert np.array_equal(a, r.numpy())
    # a window sized for 1-bit codes: most runs go straight to the block's
    # metadata, with the same result
    small = _b4c_tiles(data.reshape(-1, 128), lens, s_local.numpy(),
                       max_len=1, tile_rows=tile_rows, seed=1, **kw)
    for a, r in zip(small, ref):
        assert np.array_equal(a, r.numpy())
    if kind == "lacks" or cut or seg_bits < 64:
        return  # the JAX kernel's slots; its oracle holds the rest
    # the JAX pipeline's counts, and its gaps from the model's firsts as
    # encode_blocks derives them
    jref, pallas = _jax_encode(data.reshape(g, b), jt, seg_bits, max_words,
                               n_segs)
    counts, firsts = model
    bounds = np.arange(n_segs, dtype=np.int64)[None] * seg_bits
    gaps = np.where(bounds < total[:, None],
                    np.minimum(firsts, total[:, None]) - bounds, 0)
    for p in (jref, pallas):
        assert np.array_equal(counts, p[3])
        assert np.array_equal(gaps, p[2])


def _b4d_rows(pay, bits, s_local, rows_per_block, out_words, seed=0):
    """A NumPy model of csrc/gap_encode.cu's B4d: 8 lanes a row, rows in a
    random order; lane j of a step makes output quad j, 4 words aligned to
    16 bytes of the (G, out_words) output (so a block's row of words starts
    at phase g * out_words mod 4), from the row's input words masked to its
    bits, the word below coming from the lane below; a quad wholly inside
    the row is assigned at once, a partial one word by word: the row's
    first and last output words OR'ed in, the others assigned (a plain
    store: a neighbour's bits there would be lost); words outside [0,
    out_words) are dropped."""
    pay = pay.view(np.uint32).astype(np.uint64)
    n_rows, cap = pay.shape
    flat = np.zeros(n_rows // rows_per_block * out_words, np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    for r in np.random.default_rng(seed).permutation(n_rows):
        nb = min(max(int(bits[r]), 0), 32 * cap)
        if nb == 0:
            continue
        g = r // rows_per_block
        o = g * out_words  # the block's first word in the flat output
        s = int(s_local[r])
        w0, sh = s >> 5, s & 31
        nw, last = -(-nb // 32), (sh + nb - 1) >> 5
        a = (w0 + o) % 4  # w0's place in its aligned quad
        n_quads = (a + last) // 4 + 1
        k = np.arange(4 * n_quads + 1) - a - 1  # input words, one below
        keep = np.clip(nb - 32 * k, 0, 32).astype(np.uint64)
        inp = np.where((k >= 0) & (k < nw), pay[r, np.clip(k, 0, cap - 1)], 0)
        inp &= ((np.uint64(1) << keep) - np.uint64(1)) << (np.uint64(32) - keep)
        v = inp[1:] >> np.uint64(sh)
        if sh:
            v |= (inp[:-1] << np.uint64(32 - sh)) & m32
        for j in range(n_quads):
            kq = 4 * j - a + np.arange(4)  # the row's output words
            e = w0 + kq
            q = v[4 * j : 4 * j + 4]
            if kq[0] >= 1 and kq[3] <= last - 1 and e[0] >= 0 \
                    and e[3] < out_words:
                flat[o + e] = q
                continue
            for t in range(4):
                if not (0 <= kq[t] <= last and 0 <= e[t] < out_words):
                    continue
                if kq[t] in (0, last):
                    flat[o + e[t]] |= q[t]
                else:
                    flat[o + e[t]] = q[t]
    return flat.reshape(-1, out_words).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("kind,max_len,out_cut", [
    ("0.5", 16, 0), ("0.9", 16, 0), ("single", 16, 0), ("uniform", 8, 0),
    ("0.5", 16, 100),   # out_words cut short
    ("lacks", 16, 0),   # a row of 0 bits
])
def test_b4d_quad_model_matches_plain(kind, max_len, out_cut):
    # 3 blocks: their rows of words start at phases 0, 1, 2 of a quad
    g, b = 3, 2048
    data = _input("0.5" if kind == "lacks" else kind, g * b, 10)
    if kind == "lacks":
        data[256:384] = 250
        _, pt = _lacking_table(data)
    else:
        _, pt = _tables(data, max_len)
    enc = ils_enc_tabs(pt, device="cpu")
    rows = torch.from_numpy(data.copy()).view(torch.int32).view(-1, 32)
    # cap_words 64 (rows of up to 17 quads, three steps) and 6 (rows cut
    # short, bits clamped to 192)
    for cap in (ge.row_cap_words(max_len), 6):
        pay, bits = ge.gap_row_pack(rows, enc, cap_words=cap)
        bits_blk = bits.view(g, -1).to(torch.int64)
        s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
        bits = bits.clone()
        bits[5] = 0  # a row skipped though its words are not zero
        # odd: the blocks' rows of words start at quad phases 0, 1, 2
        out_words = (int(bits_blk.sum(1).max()) // 32 + 2 - out_cut) | 1
        kw = dict(rows_per_block=b // 128, out_words=out_words)
        ref = ge.gap_place_bits_plain(pay, bits, s_local, **kw).numpy()
        got = _b4d_rows(pay.numpy(), bits.numpy(), s_local.numpy(), **kw)
        assert np.array_equal(got, ref), cap


# ----------------------------------------------------------------------
# Tile geometry of the CUDA kernels B4b and B1
# ----------------------------------------------------------------------
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block can have (H100)


@pytest.mark.parametrize("max_len", range(1, 17))
def test_row_pack_tile_fits_shared_memory(max_len):
    cap = ge.row_cap_words(max_len)
    rows, smem = ge.row_pack_tile(cap)
    assert rows % 32 == 0 and 32 <= rows <= 256
    # input and packed words, each pitch odd in words; the (256,) int32
    # code table is static shared memory besides
    assert smem == 4 * rows * (33 + cap + 1)
    assert cap % 2 == 0 and (cap + 1) % 2 == 1
    assert smem + 1024 <= SMEM_PER_BLOCK
    # a block's pay range starts 16-byte aligned
    assert rows * cap * 4 % 16 == 0


@pytest.mark.parametrize("seg_bits", [2 ** k for k in range(3, 14)])
def test_meta_tile_window_covers_span(seg_bits):
    for max_len in range(1, 17):
        rows, window, smem = ge.meta_tile(seg_bits, max_len)
        assert rows & (rows - 1) == 0 and 1 <= rows <= ge.META_MAX_ROWS
        # R rows of max_len-bit codes span under R * 128 * max_len bits
        # from the tile's first start, which lies anywhere in its segment
        span = rows * 128 * max_len
        assert window >= (seg_bits - 1 + span - 1) // seg_bits + 1
        # two ints a segment, beside the static 1 KB length table, under
        # the 48 KB a block gets without opting in
        assert smem == 8 * window and smem + 1032 <= 49152 <= SMEM_PER_BLOCK
        # the most rows that fit, and all 512 at the main path's seg_bits
        if rows < ge.META_MAX_ROWS:
            assert 8 * (-(-2 * span // seg_bits) + 1) > 47104
        if seg_bits >= 256:
            assert rows == ge.META_MAX_ROWS == 512


@pytest.mark.parametrize("seg_bits", [2 ** k for k in range(3, 14)])
def test_ranks_tile_fits_shared_memory(seg_bits):
    # the staged row covers every word a valid segment reads: its last
    # codeword starts below the segment's end, at any phase of the
    # segment's start in its word; the window holds that word and the
    # next, has loaded a third, and the last skip may load a fourth
    need = max(((s * seg_bits) % 32 + seg_bits - 1) // 32 + 4
               for s in range(32))
    assert gd.stage_words(seg_bits) >= need
    # every max_count a segment of seg_bits can need, 1-bit codes included
    for max_count in range(1, gd.count_max(seg_bits, 1) + 9):
        rows, chunk, pitch, smem = gd.ranks_tile(max_count, seg_bits)
        assert rows == 128
        assert chunk % 8 == 0 and 8 <= chunk <= 64
        assert chunk >= min(max_count, 64)
        assert (chunk + 4) // 4 % 2 == 1  # odd rank pitch in words
        # staged rows of an odd pitch in words, or none
        assert pitch in (0, gd.stage_words(seg_bits) | 1)
        # the staged rows and the rank tile; lim and bias, (32,) each,
        # are static shared memory besides
        assert smem == rows * (chunk + 4 + 4 * pitch)
        assert smem <= gd.RANK_MAX_SMEM and smem + 256 <= SMEM_PER_BLOCK
        # staged where an SM still holds 1024 of its threads
        held = rows * min(gd.SM_THREADS // rows, gd.SM_SMEM // (
            rows * (chunk + 4 + 4 * (gd.stage_words(seg_bits) | 1))
            + gd.BLOCK_EXTRA_SMEM))
        assert (pitch > 0) == (held >= gd.SM_MIN_THREADS)
        # the codec's and the foreign paths' seg_bits are staged, at the
        # widest chunk too; past 1024 bits the rows cost threads
        assert (pitch > 0) == (seg_bits <= 1024)


@pytest.mark.parametrize("seg_bits", [2 ** k for k in range(3, 11)])
def test_ranks_tile_holds_eight_placing_blocks(seg_bits):
    # the placing form (gap_decode_bytes) takes ranks_tile's tile and 256 B
    # of static shared memory more (symtab): at every staged seg_bits and
    # max_count an SM still holds 8 of its blocks of 128, and a row's chunk
    # at a phase of up to 3 bytes fits its tile row of chunk + 4
    static = 32 * 4 + 32 * 4 + 256  # lim, bias (32 words each), symtab
    assert gd.BLOCK_EXTRA_SMEM >= 1024 + static
    for max_count in range(1, gd.count_max(seg_bits, 1) + 9):
        rows, chunk, pitch, smem = gd.ranks_tile(max_count, seg_bits)
        assert pitch > 0
        blocks = min(gd.SM_THREADS // rows,
                     gd.SM_SMEM // (smem + gd.BLOCK_EXTRA_SMEM))
        assert blocks >= 8 and rows * blocks >= gd.SM_MIN_THREADS
        assert 3 + chunk <= chunk + 4 and chunk % 8 == 0


# ----------------------------------------------------------------------
# B1: a NumPy model of csrc/gap_decode.cu's staged walk
# ----------------------------------------------------------------------
def _stage_items(pitch):
    """(row, word) of lane l's item k in `stage_warp_rows`, walked as the
    kernel walks it: (32, pitch) each."""
    rows = np.zeros((32, pitch), np.int64)
    cols = np.zeros((32, pitch), np.int64)
    dr, dj = divmod(32, pitch)
    for lane in range(32):
        r, j = divmod(lane, pitch)
        for k in range(pitch):
            rows[lane, k], cols[lane, k] = r, j
            r, j = r + dr, j + dj
            if j >= pitch:
                r, j = r + 1, j - pitch
    return rows, cols


def _b1_model(words, gaps, counts, lim, bias, *, seg_bits, max_count,
              min_len, max_len):
    """gap_decode_ranks_kernel on every segment at once, with the geometry
    of `ranks_tile`: (ranks, device reads, top) with the words each
    segment read from device memory (outside its staged row) and the
    highest word of its row that it read (-1: none)."""
    words = np.asarray(words).view(np.uint32).astype(np.int64)
    g_n, n_words = words.shape
    n_segs = gaps.shape[1]
    total = g_n * n_segs
    pitch = gd.ranks_tile(max_count, seg_bits)[2]
    t = np.arange(total, dtype=np.int64)
    g = t // n_segs
    s0 = (t - g * n_segs) * seg_bits
    pos = s0 + gaps.reshape(-1).astype(np.int64)
    base = s0 >> 5
    n = np.clip(counts.reshape(-1).astype(np.int64), 0, max_count)
    flat = np.r_[words.reshape(-1), 0]

    def device(i, gg):  # a block's word i, zero outside it
        ok = (i >= 0) & (i < n_words)
        return flat[np.where(ok, gg * n_words + i, flat.size - 1)]

    # each warp copies its 32 rows through the lane walk; a row past the
    # last segment is not staged (its words stay unknown)
    n_pad = -(-total // 32) * 32
    stage = np.full((n_pad, max(pitch, 1)), 0xDEADBEEF, np.int64)
    if pitch:
        r_of, j_of = _stage_items(pitch)
        copies = np.zeros(stage.shape, np.int64)
        for w0 in range(0, n_pad, 32):
            r = w0 + r_of.reshape(-1)
            j = j_of.reshape(-1)
            live = r < total
            r, j = r[live], j[live]
            stage[r, j] = device(base[r] + j, g[r])
            np.add.at(copies, (r, j), 1)
        assert (copies[:total] == 1).all()  # every word of a row once
        assert not copies[total:].any()

    reads = np.zeros(total, np.int64)
    top = np.full(total, -1, np.int64)
    act = n > 0

    def word(rel, m):
        staged = (rel >= 0) & (rel < pitch)
        reads[m & ~staged] += 1
        top[:] = np.where(m & staged, np.maximum(top, rel), top)
        return np.where(staged, stage[t, np.clip(rel, 0, max(pitch, 1) - 1)],
                        device(base + rel, g))

    rel = (pos >> 5) - base
    q = pos & 31
    w0, w1, w2 = word(rel, act), word(rel + 1, act), word(rel + 2, act)
    rel = rel + 3
    lim = lim.numpy().astype(np.int64) & _M32
    bias = bias.numpy().astype(np.int64)
    ranks = np.zeros((total, max_count), np.uint8)
    for i in range(max_count):
        on = i < n
        if not on.any():
            break
        win = ((w0 << q) | (w1 >> (32 - q))) & _M32
        ln = _canon(win, lim, min_len, max_len)
        ranks[:, i] = np.where(on, (bias[ln] + (win >> (32 - ln))) & 255, 0)
        q = q + np.where(on, ln, 0)
        ref = on & (q >= 32)
        q = np.where(ref, q - 32, q)
        nxt = word(rel, ref)
        w0, w1, w2 = (np.where(ref, w1, w0), np.where(ref, w2, w1),
                      np.where(ref, nxt, w2))
        rel = rel + ref
    return ranks, reads, top


_UNSET = 0x1AB  # an output byte no store reached (not a byte value)


def _b1_place_model(words, gaps, counts, offsets, lim, bias, symtab, *,
                    seg_bits, max_count, min_len, max_len, n_out, zero_tail):
    """gap_decode_bytes_kernel: the walk of `_b1_model`, each rank through
    symtab into a tile row of chunk + 4 bytes at the output's phase, then
    each warp's rows stored as `place_warp_rows` stores them (the words
    wholly inside a row's bytes through the lane walk of `place_words`,
    4-byte stores at aligned addresses where the run lies in the output;
    a row's head and tail words byte by byte; the last partial word of a
    row that goes on carried into the next chunk's word 0), then, where
    zero_tail, [total, n_out) zeroed.  Returns (out, writes): out as
    int64, _UNSET where no store reached a byte (where the caller has not
    zero-filled it), and the stores each byte took."""
    ranks, _, _ = _b1_model(words, gaps, counts, lim, bias, seg_bits=seg_bits,
                            max_count=max_count, min_len=min_len,
                            max_len=max_len)
    total = ranks.shape[0]
    _, chunk, _, _ = gd.ranks_tile(max_count, seg_bits)
    pw = (chunk + 4) // 4
    assert pw % 2 == 1
    n_pad = -(-total // 32) * 32
    n = np.zeros(n_pad, np.int64)
    n[:total] = np.clip(counts.reshape(-1).astype(np.int64), 0, max_count)
    off = np.zeros(n_pad, np.int64)
    off[:total] = np.asarray(offsets, np.int64)
    ph = off & 3
    sym = np.asarray(symtab).astype(np.int64) & 255
    out = np.full(n_out, _UNSET if zero_tail else 0, np.int64)
    writes = np.zeros(n_out, np.int64)

    def put(dst, val, checked=True):
        ok = (dst >= 0) & (dst < n_out) if checked else np.ones(dst.shape, bool)
        assert (val[ok] >= 0).all()  # only bytes the walk wrote go out
        out[dst[ok]] = val[ok]
        np.add.at(writes, dst[ok], 1)

    tile = np.full((n_pad, 4 * pw), -1, np.int64)
    rows = np.arange(n_pad)
    for lo in range(0, max_count, chunk):
        width = min(chunk, max_count - lo)
        m = np.clip(n - lo, 0, width)
        for i in range(width):
            on = np.flatnonzero(i < m)
            tile[on, ph[on] + i] = sym[ranks[on, lo + i]]
        a = off + lo - ph  # the output byte of a row's byte 0
        assert not (a % 4).any()
        v0 = ph if lo == 0 else np.zeros_like(ph)
        e = ph + m
        ends = (m > 0) & (lo + m == n)
        miss = (e <= v0) | (a + e <= 0) | (a + v0 >= n_out)
        inside = (a + v0 >= 0) & (a + e <= n_out)
        w0 = (v0 + 3) >> 2
        w1 = np.where(miss, w0, e >> 2)
        for r0 in range(0, n_pad, 32):
            span = int(w1[r0 : r0 + 32].max())
            if not span:
                continue
            x = np.arange(32 * span)  # lane x % 32 takes item x at x // 32
            r, j = r0 + x // span, x % span
            st = (j >= w0[r]) & (j < w1[r])
            r, j = r[st], j[st]
            d = a[r] + 4 * j
            whole = inside[r]
            assert (d[whole] % 4 == 0).all()
            for k in range(4):
                put(d + k, tile[r, 4 * j + k])
        # the head and the tail, byte by byte
        head = (v0 & 3 > 0) & (e > v0)
        tail = ends & (e & 3 > 0) & (e > 4 * w0)
        for b in range(4):
            hb = head & (b >= v0) & (b < np.minimum(e, 4))
            put(a[hb] + b, tile[hb, b])
            tb = tail & (b < (e & 3))
            put(a[tb] + (e[tb] & ~3) + b, tile[tb, (e[tb] & ~3) + b])
        # a row that goes on carries its last partial word into word 0
        go = (lo + width < n) & ((ph + width) & 3 > 0)
        q = (ph + width) >> 2
        tile[go, 0:4] = tile[np.c_[rows[go]], 4 * q[go, None] + np.arange(4)]
    if zero_tail:
        last = total - 1
        end = max(off[last] + n[last], 0)
        out[end:] = 0
        writes[end:] += 1
    return out, writes


def _b1_banks(seg_bits):
    """Banks that the 32 rows of a warp read at the same offset j of their
    staged rows, for each j: (P, 32)."""
    pitch = gd.stage_words(seg_bits) | 1
    y = np.arange(32)[None, :] * pitch + np.arange(pitch)[:, None]
    return y % 32


def _b1_kw(pt, seg_bits, max_count):
    spec = tt.dec_spec(pt)
    lim, bias = gd.kernel_tabs(tt.device_dec_table(pt, device="cpu"))
    return (lim, bias), dict(seg_bits=seg_bits, max_count=max_count,
                             min_len=spec.min_len, max_len=spec.max_len)


def _b1_blocks(parts, pt, seg_bits):
    """(words, gaps, counts) of G blocks, each a valid stream of its data,
    stacked at the longest block's shape (zeros past each)."""
    cases = [_ranks_case(d, pt, seg_bits) for d in parts]
    nw = max(c[0].size for c in cases)
    ns = max(c[1].size for c in cases)
    words = np.zeros((len(parts), nw), np.uint32)
    gaps = np.zeros((len(parts), ns), np.int32)
    counts = np.zeros((len(parts), ns), np.int32)
    for i, (w, gp, c) in enumerate(cases):
        words[i, : w.size], gaps[i, : gp.size], counts[i, : c.size] = w, gp, c
    return words, gaps, counts


@pytest.mark.parametrize("kind,sizes,seg_bits", [
    # three blocks of 45-ish segments: warps and tiles cross blocks
    ("0.1", (1400, 1500, 900), 1024),
    ("0.5", (700, 333, 801), 128),
    ("0.9", (300, 200), 8),
    ("uniform", (500, 257), 32),
    ("0.3", (9000,), 512),
    ("single", (3000,), 256),
    # segments of 7 (blocks fewer than a warp's rows)
    ("0.5", (100,) * 9, 128),
])
def test_b1_staged_model_matches_plain(kind, sizes, seg_bits):
    # the staged walk of a valid stream reads only its rows, never device
    # memory, and no word of its row past stage_words; its ranks are the
    # plain version's
    parts = [_input(kind, m, 3 + i) for i, m in enumerate(sizes)]
    _, pt = _tables(np.concatenate(parts))
    words, gaps, counts = _b1_blocks(parts, pt, seg_bits)
    (lim, bias), kw = _b1_kw(pt, seg_bits, -(-int(counts.max()) // 8) * 8)
    got, reads, top = _b1_model(words, gaps, counts, lim, bias, **kw)
    plain = gd.gap_decode_ranks(_t(words.view(np.int32)), _t(gaps),
                                _t(counts), lim, bias, **kw).numpy()
    assert np.array_equal(got, plain)
    assert not reads.any()
    assert top.max() < gd.stage_words(seg_bits)
    assert (top[counts.reshape(-1) > 0] >= 0).all()
    # the rows of a warp at one offset of their words: 32 banks
    assert all(len(set(b)) == 32 for b in _b1_banks(seg_bits))


def _b1_place_args(counts, shift=0):
    """(flat counts, offsets): the exclusive prefix sum of the counts,
    shifted by `shift`."""
    flat = counts.reshape(-1).astype(np.int64)
    return flat, np.cumsum(flat) - flat + shift


def _b1_place_check(words, gaps, counts, offsets, lim, bias, symtab, kw,
                    n_out, zero_tail):
    """The placing model against gap_place_bytes_plain(
    gap_decode_ranks_plain(...)) and the plain gap_decode_bytes: equal, and
    every byte stored at most once (each once where zero_tail)."""
    got, writes = _b1_place_model(words, gaps, counts, offsets, lim, bias,
                                  symtab, n_out=n_out, zero_tail=zero_tail,
                                  **kw)
    args = (_t(words.view(np.int32)), _t(gaps), _t(counts))
    offs = _t(offsets, np.int64)
    ref = gd.gap_place_bytes_plain(
        gd.gap_decode_ranks_plain(*args, lim, bias, **kw),
        _t(counts.reshape(-1)), offs, symtab, n_out=n_out).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(gd.gap_decode_bytes(
        *args, offs, lim, bias, symtab, n_out=n_out,
        counts_in_range=zero_tail, **kw).numpy(), ref)
    assert writes.max(initial=0) <= 1
    if zero_tail:
        assert (writes == 1).all()
    return got


def _b1_symtab(pt):
    return tt.device_dec_table(pt, device="cpu").symtab


@pytest.mark.parametrize("kind,sizes,seg_bits", [
    ("0.1", (1400, 1500, 900), 1024),
    ("0.5", (700, 333, 801), 128),
    ("0.9", (300, 200), 8),
    ("uniform", (500, 257), 32),
    ("0.3", (9000,), 512),
    ("single", (3000,), 256),
    ("0.5", (100,) * 9, 128),
])
def test_b1_place_model_matches_plain(kind, sizes, seg_bits):
    # the placing form at the staged model's shapes: the offsets tile the
    # output, so every byte is stored once by the kernel, at n_out equal
    # to the counts' total (the blocks' bytes), above it (the kernel
    # zeroes the rest) and below it (stores past n_out dropped); and,
    # zero-filled first, with the offsets shifted before the output
    parts = [_input(kind, m, 3 + i) for i, m in enumerate(sizes)]
    _, pt = _tables(np.concatenate(parts))
    words, gaps, counts = _b1_blocks(parts, pt, seg_bits)
    (lim, bias), kw = _b1_kw(pt, seg_bits, -(-int(counts.max()) // 8) * 8)
    sym = _b1_symtab(pt)
    flat, offs = _b1_place_args(counts)
    total = int(flat.sum())
    got = _b1_place_check(words, gaps, counts, offs, lim, bias, sym, kw,
                          total, True)
    assert np.array_equal(got, np.concatenate(parts))
    for n_out in (total + 37, total - 5):
        _b1_place_check(words, gaps, counts, offs, lim, bias, sym, kw, n_out,
                        True)
    _b1_place_check(words, gaps, counts, offs - 13, lim, bias, sym, kw,
                    total, False)


def test_b1_staged_model_matches_jax():
    # two blocks through the model and the JAX kernel in interpret mode
    parts = [generate_redundant(m, 0.5, seed=9 + i)
             for i, m in enumerate((900, 650))]
    jt, pt = _tables(np.concatenate(parts))
    words, gaps, counts = _b1_blocks(parts, pt, 128)
    mc = int(counts.max())
    (lim, bias), kw = _b1_kw(pt, 128, mc)
    got, reads, _ = _b1_model(words, gaps, counts, lim, bias, **kw)
    assert not reads.any()
    ns = gaps.shape[1]
    for b in range(2):
        packed = np.asarray(decode_ranks_pallas(
            jnp.asarray(words[b]), jnp.asarray(gaps[b]),
            jnp.asarray(counts[b]), jdevice_dec_table(jt, two_level=False),
            spec=jdec_spec(jt), seg_bits=128, n_segs=ns, max_count=mc,
            interpret=True))
        jr = (packed.view(np.uint8).reshape(packed.shape[0], -1, 4)
              .transpose(1, 0, 2).reshape(packed.shape[1], -1))
        for s in range(ns):
            c = counts[b, s]
            assert np.array_equal(got[b * ns + s, :c], jr[s, :c]), (b, s)


@pytest.mark.parametrize("seg_bits,max_count", [(128, 64), (1024, 37),
                                                (8, 9), (4096, 40)])
def test_b1_staged_model_exact_on_corrupt_metadata(seg_bits, max_count):
    # negative and oversized gaps, counts past max_count and negative,
    # words cut short of the segments: walks leave their rows and read
    # device memory, zeros past each block, and stay the plain version's
    rng = np.random.default_rng(seg_bits)
    _, pt = _tables(generate_redundant(4000, 0.5, seed=6))
    g, ns = 3, 45
    nw = max(ns * seg_bits // 32 // 2, 3)
    words = rng.integers(0, 2**32, (g, nw), dtype=np.uint64).astype(np.uint32)
    gaps = rng.integers(-3 * seg_bits, 3 * seg_bits, (g, ns)).astype(np.int32)
    gaps[0, :10] = rng.integers(0, 16, 10)  # a few in their segment
    counts = rng.integers(-5, max_count + 100, (g, ns)).astype(np.int32)
    (lim, bias), kw = _b1_kw(pt, seg_bits, max_count)
    got, reads, _ = _b1_model(words, gaps, counts, lim, bias, **kw)
    plain = gd.gap_decode_ranks(_t(words.view(np.int32)), _t(gaps),
                                _t(counts), lim, bias, **kw).numpy()
    assert np.array_equal(got, plain)
    assert reads.any()


@pytest.mark.parametrize("seg_bits,max_count", [(128, 64), (1024, 37),
                                                (8, 9), (4096, 40)])
def test_b1_place_model_exact_on_corrupt_metadata(seg_bits, max_count):
    # the placing form at the corrupt shapes: zero-filled first, offsets
    # the prefix sum of the clamped counts shifted to start before the
    # output (disjoint, some outside), n_out short of their end; then the
    # counts clamped into [0, max_count] (the kernel fills the output
    # itself) at n_out past their total
    rng = np.random.default_rng(seg_bits)
    _, pt = _tables(generate_redundant(4000, 0.5, seed=6))
    g, ns = 3, 45
    nw = max(ns * seg_bits // 32 // 2, 3)
    words = rng.integers(0, 2**32, (g, nw), dtype=np.uint64).astype(np.uint32)
    gaps = rng.integers(-3 * seg_bits, 3 * seg_bits, (g, ns)).astype(np.int32)
    gaps[0, :10] = rng.integers(0, 16, 10)  # a few in their segment
    counts = rng.integers(-5, max_count + 100, (g, ns)).astype(np.int32)
    (lim, bias), kw = _b1_kw(pt, seg_bits, max_count)
    sym = _b1_symtab(pt)
    _, offs = _b1_place_args(np.clip(counts, 0, max_count), -50)
    _b1_place_check(words, gaps, counts, offs, lim, bias, sym, kw,
                    int(offs[-1]) - 7, False)
    kept = np.clip(counts, 0, max_count).astype(np.int32)
    flat, offs = _b1_place_args(kept)
    _b1_place_check(words, gaps, kept, offs, lim, bias, sym, kw,
                    int(flat.sum()) + 45, True)


# ----------------------------------------------------------------------
# C1: a NumPy model of csrc/gap_decode.cu's count-table walk
# ----------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _canon(win, lim, min_len, max_len):
    """The compare chain on u32 windows (int64): min_len + #{l in
    [min_len, max_len): win >= lim[l]}."""
    ln = np.full(win.shape, min_len, np.int64)
    for lv in range(min_len, max_len):
        ln += win >= lim[lv]
    return ln


def _c1_table(lim, min_len, max_len, bits=gd.COUNT_TAB_BITS):
    """gap_count_table_kernel: per `bits`-bit prefix, (n, total bits, first
    length) of the codewords it decides, walking on while the prefix's
    lowest and highest completions give one length, and taking the
    codeword that crosses its end too."""
    prefix = np.arange(1 << bits, dtype=np.int64) << (32 - bits)
    p = np.zeros(prefix.shape, np.int64)
    n, first = np.zeros_like(p), np.zeros_like(p)
    active = np.ones(prefix.shape, bool)
    while active.any():
        q = np.minimum(p, bits - 1)  # active entries have p < bits
        lo = (prefix << q) & _M32
        ln = _canon(lo, lim, min_len, max_len)
        ok = active & (_canon(lo | (_M32 >> (bits - q)), lim, min_len,
                              max_len) == ln)
        first = np.where(ok & (n == 0), ln, first)
        n, p = n + ok, np.where(ok, p + ln, p)
        active = ok & (p < bits)
    return n, p, first


def _c1_model(words, gaps, lim, *, seg_bits, total_bits, min_len, max_len,
              bits=gd.COUNT_TAB_BITS):
    """gap_count_segments_kernel on every segment at once: (counts, steps),
    steps counting the table's multi-codeword steps and the single steps
    taken for `end`, for the cap and where the prefix decides nothing."""
    words = np.asarray(words).view(np.uint32).astype(np.int64)
    n_words = words.size
    flat = np.r_[words, 0]
    max_count = gd.count_max(seg_bits, min_len)
    pos = np.arange(gaps.size, dtype=np.int64) * seg_bits + gaps
    end = np.minimum(np.r_[pos[1:], total_bits], total_bits)
    steps = dict.fromkeys(("multi", "end", "cap", "chain"), 0)
    if min_len == max_len:
        count = np.where(pos < end, np.minimum(
            (end - pos + max_len - 1) // max_len, max_count), 0)
        return count.astype(np.int32), steps
    n_tab, bits_tab, first_tab = _c1_table(lim, min_len, max_len, bits)

    def word(i):
        return flat[np.where((i >= 0) & (i < n_words), i, n_words)]

    count = np.zeros_like(pos)
    while True:
        act = (pos < end) & (count < max_count)
        if not act.any():
            break
        sh = pos & 31
        win = ((word(pos >> 5) << sh) & _M32) | (word((pos >> 5) + 1)
                                                 >> (32 - sh))
        x = win >> (32 - bits)
        n, b = n_tab[x], bits_tab[x]
        chain = n == 0
        by_end = ~chain & (pos + b > end)
        by_cap = ~chain & ~by_end & (count + n > max_count)
        single = by_end | by_cap
        step_n = np.where(chain | single, 1, n)
        step_b = np.where(chain, _canon(win, lim, min_len, max_len),
                          np.where(single, first_tab[x], b))
        count += np.where(act, step_n, 0)
        pos += np.where(act, step_b, 0)
        for key, m in (("multi", ~chain & ~single), ("end", by_end),
                       ("cap", by_cap), ("chain", chain)):
            steps[key] += int((act & m).sum())
    return count.astype(np.int32), steps


def _c1_case(kind, n, seed=1):
    """(data, JAX table, port table) of a count case: "skew16" has every
    length 1..16 (limits that are not byte-aligned; prefixes that decide
    nothing), its 17 symbols drawn alike so that codes longer than the
    table's window are common; "three" lengths 1, 2, 2 (many codewords a
    step)."""
    if kind == "skew16":
        syms = np.r_[np.arange(40, 55), 56, 55].astype(np.uint8)
        lens = np.r_[np.arange(1, 16), 16, 16]
        data = syms[np.random.default_rng(seed).integers(0, 17, n)]
        return (data, jtable_from_length_sequence(syms, lens),
                table_from_length_sequence(syms, lens))
    if kind == "three":
        data = np.random.default_rng(seed).choice(
            np.array([5, 6, 7], np.uint8), n, p=[0.5, 0.25, 0.25])
    else:
        data = _input(kind, n, seed)
    return (data, *_tables(data))


def _c1_lim(pt):
    lim = gd.kernel_tabs(tt.device_dec_table(pt, device="cpu"))[0]
    return lim, lim.numpy().astype(np.int64) & _M32


@pytest.mark.parametrize("kind", ["skew16", "three", "0.5", "0.9", "uniform"])
def test_c1_count_table_matches_compare_chain(kind):
    # every prefix: the chain walked on its lowest, its highest and 16
    # random completions decides the entry's codewords, bits and first
    # length; an empty entry's first codeword has two lengths there
    _, _, pt = _c1_case(kind, 4000)
    _, lim = _c1_lim(pt)
    min_len, max_len = pt.min_len, pt.max_len_present
    bits = gd.COUNT_TAB_BITS
    n, p, first = _c1_table(lim, min_len, max_len)
    x = np.arange(1 << bits, dtype=np.int64)
    span = (1 << (64 - bits)) - 1
    rng = np.random.default_rng(7)
    for fill in [0, span] + list(rng.integers(0, span + 1, 16)):
        # a 64-bit stream from the prefix: its first codewords' lengths
        stream = (x << (64 - bits)) | fill
        at, k, got_first = np.zeros_like(x), np.zeros_like(x), None
        while True:
            live = k < n
            if not live.any():
                break
            win = (stream >> (32 - np.minimum(at, 32))) & _M32
            ln = _canon(win, lim, min_len, max_len)
            got_first = ln if got_first is None else got_first
            at, k = np.where(live, at + ln, at), k + live
        full = n > 0
        assert np.array_equal(at[full], p[full])
        assert np.array_equal(got_first[full], first[full])
    lo, hi = x << (32 - bits), (x << (32 - bits)) | (_M32 >> bits)
    assert np.array_equal(n == 0, _canon(lo, lim, min_len, max_len)
                          != _canon(hi, lim, min_len, max_len))
    assert p.max() <= bits - 1 + max_len and n.max() <= bits
    if kind == "skew16":
        # limits that are not byte-aligned leave prefixes deciding nothing
        # (a run of ones of this unary-like code decides no length)
        assert (n == 0).any()
    else:
        # a codeword whose length its first bits decide crosses the end
        assert (p > bits).any()
    if kind == "three":
        assert n.max() == bits


@pytest.mark.parametrize("kind", ["skew16", "three", "0.5", "single"])
@pytest.mark.parametrize("seg_bits", [128, 256])
def test_c1_model_matches_plain_and_jax(kind, seg_bits):
    # the exact bit count and the format's word-count bound, held to the
    # plain version and to the JAX kernel in interpret mode; and a bound
    # past the words (which read as zeros), held to the plain version (the
    # JAX kernel reads its own padding there)
    data, jt, pt = _c1_case(kind, 4000)
    words, total_bits = jnpref.encode_bits(data, jt)
    words = words[:-1]
    gaps = jnpref.segment_metadata(data, jt, seg_bits)[0].astype(np.int32)
    lim_t, lim = _c1_lim(pt)
    spec = tt.dec_spec(pt)
    lens = dict(min_len=spec.min_len, max_len=spec.max_len)
    jdec, jspec = jdevice_dec_table(jt, two_level=False), jdec_spec(jt)
    words_j = jnp.asarray(np.concatenate([words, np.zeros(2, np.uint32)]))
    n = gaps.size
    for bound in (total_bits, words.size * 32, words.size * 32 + 70):
        kw = dict(seg_bits=seg_bits, total_bits=bound, **lens)
        got, steps = _c1_model(words, gaps, lim, **kw)
        plain = gd.count_segments(_t(words.view(np.int32)), _t(gaps), lim_t,
                                  **kw).numpy()
        assert np.array_equal(got, plain)
        if bound > words.size * 32:
            continue
        starts = np.arange(n) * seg_bits + gaps.astype(np.int64)
        budgets = np.minimum(np.r_[starts[1:], bound], bound) - starts
        ref = count_segments_pallas(
            words_j, jnp.asarray(gaps), jnp.asarray(budgets.astype(np.int32)),
            jdec, spec=jspec, seg_bits=seg_bits, n_segs=n, interpret=True)
        assert np.array_equal(got, np.asarray(ref)[:n])
        if kind != "single":
            # most codewords go several to a step; every segment's end
            # falls inside a step somewhere
            assert steps["multi"] > steps["end"] > 0
        if kind == "skew16":
            assert steps["chain"] > 0


@pytest.mark.parametrize("kind", ["skew16", "0.9", "single"])
def test_c1_model_caps_corrupt_gaps(kind):
    # gaps far past the segment grid and before the stream: the cap is met
    # inside a multi-codeword step, and reads outside the words are zeros
    data, _, pt = _c1_case(kind, 3000)
    words, total_bits = npref.encode_bits(data, pt)
    words = words[:-1]
    rng = np.random.default_rng(5)
    gaps = rng.integers(-3000, 6000, 60).astype(np.int32)
    lim_t, lim = _c1_lim(pt)
    kw = dict(seg_bits=128, min_len=pt.min_len, max_len=pt.max_len_present)
    for bound in (total_bits, words.size * 32 + 5000):
        got, steps = _c1_model(words, gaps, lim, total_bits=bound, **kw)
        plain = gd.count_segments(_t(words.view(np.int32)), _t(gaps), lim_t,
                                  total_bits=bound, **kw).numpy()
        assert np.array_equal(got, plain)
        assert got.max() == gd.count_max(128, pt.min_len)
        if kind != "single":
            assert steps["cap"] > 0


def test_wrappers_reject_bad_input():
    with pytest.raises(TypeError):
        ge.gap_row_pack(torch.zeros((2, 32), dtype=torch.int64),
                        torch.zeros(256, dtype=torch.int32), cap_words=4)
    with pytest.raises(ValueError, match="rows must be"):
        ge.gap_row_pack(torch.zeros((2, 31), dtype=torch.int32),
                        torch.zeros(256, dtype=torch.int32), cap_words=4)
    with pytest.raises(ValueError, match="power of two"):
        ge.gap_row_meta(torch.zeros((2, 32), dtype=torch.int32),
                        torch.zeros(256, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int64), rows_per_block=2,
                        n_segs=4, seg_bits=100)
    with pytest.raises(ValueError, match="rows must be"):
        ge.gap_row_meta(torch.zeros((3, 32), dtype=torch.int32),
                        torch.zeros(256, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int64), rows_per_block=2,
                        n_segs=4, seg_bits=128)
    with pytest.raises(ValueError, match="max_len"):
        ge.gap_row_meta(torch.zeros((2, 32), dtype=torch.int32),
                        torch.zeros(256, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int64), rows_per_block=2,
                        n_segs=4, seg_bits=128, max_len=17)
    # blocks of any size but 0 bytes; byte counts one a block, int32
    with pytest.raises(ValueError, match="at least one byte"):
        ge.encode_blocks(torch.zeros((1, 0), dtype=torch.uint8),
                         torch.zeros(256, dtype=torch.int32), seg_bits=128,
                         max_words=512, n_segs=128, max_len=8)
    with pytest.raises(ValueError, match="n_bytes must be"):
        ge.encode_blocks(torch.zeros((2, 100), dtype=torch.uint8),
                         torch.zeros(256, dtype=torch.int32), seg_bits=128,
                         max_words=512, n_segs=128, max_len=8,
                         n_bytes=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ge.gap_row_pack(torch.zeros((2, 32), dtype=torch.int32),
                        torch.zeros(256, dtype=torch.int32), cap_words=4,
                        n_bytes=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="n_bytes must be"):
        ge.gap_row_meta(torch.zeros((4, 32), dtype=torch.int32),
                        torch.zeros(256, dtype=torch.int32),
                        torch.zeros(4, dtype=torch.int64), rows_per_block=2,
                        n_segs=4, seg_bits=128,
                        n_bytes=torch.zeros(1, dtype=torch.int32))
    z = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="invalid decode shape"):
        gd.gap_decode_ranks(torch.zeros((1, 4), dtype=torch.int32),
                            torch.zeros((1, 2), dtype=torch.int32),
                            torch.zeros((1, 2), dtype=torch.int32), z, z,
                            seg_bits=64, max_count=4, min_len=1, max_len=17)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gd.gap_place_bytes(torch.zeros((1, 4), dtype=torch.uint8, device="meta"),
                           torch.zeros(1, dtype=torch.int32, device="meta"),
                           torch.zeros(1, dtype=torch.int64, device="meta"),
                           torch.zeros(256, dtype=torch.int32, device="meta"),
                           n_out=4)


# ----------------------------------------------------------------------
# Blocks of any size: B4b and B4c with byte counts, encode_blocks
# ----------------------------------------------------------------------
def _any_size_tables(kind):
    """(jax table, port table, sample): a one-symbol table, or one holding
    all 256 symbols at lengths up to 16."""
    if kind == "single":
        sample = np.full(4096, 7, np.uint8)
    else:
        sample = np.concatenate([np.arange(256, dtype=np.uint8),
                                 generate_redundant(8192, 0.7, seed=12)])
    jt, pt = _tables(sample)
    return jt, pt, sample


def _sizing(pt, b, seg_bits):
    """encode_device's max_words and n_segs for blocks of b bytes."""
    max_words = -(-(-(-b * pt.max_len_present // 32)) // 512) * 512
    return max_words, -(-max_words * 32 // seg_bits)


def _equal_outputs(got, ref, what):
    names = ("words", "total_bits", "gaps", "counts")
    for name, a, r in zip(names, got, ref):
        a, r = np.asarray(a), np.asarray(r)
        if name == "words":
            a, r = a.view(np.uint32), r.view(np.uint32)
        assert a.shape == r.shape and np.array_equal(a, r), (what, name)


@pytest.mark.parametrize("kind", ["single", "all256"])
@pytest.mark.parametrize("seg_bits", [128, 1024])
@pytest.mark.parametrize("b", [1, 127, 129, 1000, 1001, 4095])
def test_encode_blocks_any_size_match_jax(b, seg_bits, kind):
    # blocks of B bytes, B no multiple of 128 but 1: B4b and B4c take each
    # block's byte count, the rows are the blocks zero-padded; block for
    # block the JAX package's encode_block (its route for such blocks)
    jt, pt, sample = _any_size_tables(kind)
    g = 3
    blocks = np.random.default_rng(b + seg_bits).choice(sample, (g, b))
    max_words, n_segs = _sizing(pt, b, seg_bits)
    enc = ils_enc_tabs(pt, device="cpu")
    got = ge.encode_blocks(torch.from_numpy(blocks), enc, seg_bits=seg_bits,
                           max_words=max_words, n_segs=n_segs,
                           max_len=pt.max_len_present)
    jenc = jdevice_enc_table(jt)
    ref = jax.vmap(lambda d: jencode_block(
        d, jenc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs))(
        jnp.asarray(blocks))
    _equal_outputs(got, ref, "encode_blocks")
    # B4b's bits and B4c's counts with the byte counts, at their shapes
    rows_b = -(-b // 128)
    padded = np.zeros((g, rows_b * 128), np.uint8)
    padded[:, :b] = blocks
    rows = torch.from_numpy(padded).view(torch.int32).view(-1, 32)
    nb = torch.full((g,), b, dtype=torch.int32)
    cap = ge.row_cap_words(pt.max_len_present)
    pay, bits = ge.gap_row_pack_plain(rows, enc, cap_words=cap, n_bytes=nb)
    bits_blk = bits.view(g, rows_b).to(torch.int64)
    assert np.array_equal(bits_blk.sum(1).numpy(), np.asarray(ref[1]))
    s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
    counts, _ = ge.gap_row_meta_plain(rows, enc, s_local, rows_per_block=rows_b,
                                      n_segs=n_segs, seg_bits=seg_bits,
                                      n_bytes=nb)
    assert np.array_equal(counts.numpy(), np.asarray(ref[3]))
    # without the counts the padding would be symbols
    if b % 128 and kind == "all256":
        _, bits0 = ge.gap_row_pack_plain(rows, enc, cap_words=cap)
        assert int(bits0.sum()) > int(bits.sum())


@pytest.mark.parametrize("case", [
    # (kind, B, byte counts, seg_bits, cut): a tail sharing a group with
    # full blocks; counts of 0, 1 and 128k+1; payload words and segments
    # cut short (the spare word, the starts past the last segment)
    ("all256", 4096, [4096, 0, 1, 128 * 5 + 1], 1024, False),
    ("all256", 1000, [1000, 999, 129, 128], 128, False),
    ("single", 4096, [4096, 4095, 1], 128, False),
    ("all256", 4096, [4096, 3000], 128, True),
    ("all256", 1001, [1001, 1], 1024, True),
    ("single", 777, [777], 128, True),
])
def test_encode_blocks_byte_counts_match_encode_block(case):
    # encode_blocks with explicit byte counts against the port's
    # encode_block (held to the JAX one above) on each block's own bytes
    kind, b, counts, seg_bits, cut = case
    _, pt, sample = _any_size_tables(kind)
    g = len(counts)
    blocks = np.random.default_rng(b + g).choice(sample, (g, b))
    max_words, n_segs = _sizing(pt, b, seg_bits)
    if cut:
        bits = pt.lengths.astype(np.int64)[blocks[0]].sum()
        max_words, n_segs = int(bits // 64), max(int(bits // seg_bits // 2), 1)
    enc = ils_enc_tabs(pt, device="cpu")
    kw = dict(seg_bits=seg_bits, max_words=max_words, n_segs=n_segs)
    got = ge.encode_blocks(torch.from_numpy(blocks), enc,
                           max_len=pt.max_len_present,
                           n_bytes=torch.tensor(counts, dtype=torch.int32), **kw)
    for i, nb in enumerate(counts):
        if nb == 0:
            # no symbol: no bits, no start
            assert int(got[1][i]) == 0 and not got[0][i].any()
            assert not got[2][i].any() and not got[3][i].any()
            continue
        ref = tenc.encode_block(torch.from_numpy(blocks[i, :nb].copy()), enc,
                                **kw)
        _equal_outputs([x[i] for x in got], ref, (case, i))


@pytest.mark.parametrize("case", [
    # (kind, blocks, bytes a block, byte counts, seg_bits, tile rows)
    ("0.5", 4, 4096, [4096, 0, 1, 128 * 5 + 1], 1024, None),
    ("0.5", 3, 4096, [1000, 4096, 2177], 8, None),  # several boundaries a lane
    ("lacks", 2, 4096, [3000, 129], 128, 3),        # length-0 bytes
    ("single", 2, 2048, [2047, 1], 8, 1),           # a tile a row
    ("uniform", 3, 1024, [1024, 127, 513], 64, 5),
    ("0.9", 2, 4096, [4095, 2000], 16, 2),
])
def test_b4c_tile_model_with_byte_counts_matches_plain(case):
    # the kernel's handling of byte counts (partial last rows, rows past
    # the count, a lane without symbols, hi from the last symbol) in the
    # NumPy model of its tiles, against the plain version, whose counts
    # and firsts give encode_block's metadata
    kind, g, b, counts, seg_bits, tile_rows = case
    data = _input("0.5" if kind == "lacks" else kind, g * b, 10)
    if kind == "lacks":
        data[::37] = 200 + np.arange(data[::37].size) % 56
        _, pt = _lacking_table(data)
    else:
        _, pt = _tables(data)
    lens = pt.lengths.astype(np.int64)
    enc = ils_enc_tabs(pt, device="cpu")
    nb = torch.tensor(counts, dtype=torch.int32)
    rows = torch.from_numpy(data.copy()).view(torch.int32).view(-1, 32)
    max_len = max(pt.max_len_present, 1)
    _, bits = ge.gap_row_pack(rows, enc, cap_words=ge.row_cap_words(max_len),
                              n_bytes=nb)
    bits_blk = bits.view(g, -1).to(torch.int64)
    s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
    n_segs = -(-int(bits_blk.sum(1).max()) // seg_bits) + 1
    kw = dict(rows_per_block=b // 128, n_segs=n_segs, seg_bits=seg_bits)
    ref = ge.gap_row_meta_plain(rows, enc, s_local, n_bytes=nb, **kw)
    for ml, seed in ((max_len, 0), (1, 1)):
        model = _b4c_tiles(data.reshape(-1, 128), lens, s_local.numpy(),
                           max_len=ml, tile_rows=tile_rows, seed=seed,
                           n_bytes=counts, **kw)
        for a, r in zip(model, ref):
            assert np.array_equal(a, r.numpy()), ml
    # the plain version with counts is encode_block's metadata of each
    # block's own bytes
    for i, c in enumerate(counts):
        if c == 0:
            assert not ref[0][i].any()
            continue
        blk = torch.from_numpy(data[i * b : i * b + c].copy())
        _, tb, gaps, cnt = tenc.encode_block(
            blk, enc, seg_bits=seg_bits, max_words=n_segs * seg_bits // 32,
            n_segs=n_segs)
        assert int(tb) == int(bits_blk[i].sum())
        assert np.array_equal(ref[0][i].numpy(), cnt.numpy())
