"""The HTC1 portability path of the PyTorch port against the JAX package.

Decode tables (flat LUT, two-level L1/L2), the "lut", "canonical" and
"twolevel" step decoders, the encode map B5 and `encode_block_fast`,
`GapArrayCodec(method=...)`, `decode_yamamoto(method=...)`, the streaming
fused pack D1 and the chunked placement D3.  The same seeded NumPy inputs
go through the JAX function (its Pallas kernels in interpret mode, as the
JAX suite runs them on the CPU) and through the port on CPU tensors, which
runs each kernel's plain version.  Every value is an integer: every
comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import huffman_tpu.ops.ils as jils
from huffman_tpu.core import canonical_code_table as jcct
from huffman_tpu.core import npref as jnpref
from huffman_tpu.core import package_merge_lengths as jpml
from huffman_tpu.core.canonical import build_flat_lut as jbuild_flat_lut
from huffman_tpu.core.canonical import build_two_level_table as jbuild_two_level
from huffman_tpu.core.ils_ref import ILS_LANES, ils_schedule_numer
from huffman_tpu.io.yamamoto import decode_yamamoto as jdecode_yamamoto
from huffman_tpu.ops import count_segments as jcount_segments
from huffman_tpu.ops import dec_spec as jdec_spec
from huffman_tpu.ops import decode_block as jdecode_block
from huffman_tpu.ops import device_dec_table as jdevice_dec_table
from huffman_tpu.ops import device_enc_table as jdevice_enc_table
from huffman_tpu.ops.compact import compact_ranks_device, plan_compact
from huffman_tpu.ops.encode import encode_block as jencode_block
from huffman_tpu.ops.pallas import ils_kernels as jk
from huffman_tpu.ops.pallas.encode_kernel import encode_map_pallas
from huffman_tpu.utils import generate_binomial, generate_redundant
from huffman_tpu_torch import GapArrayCodec, decode_yamamoto, write_yamamoto
from huffman_tpu_torch.core import npref
from huffman_tpu_torch.core.canonical import (
    build_flat_lut,
    build_two_level_table,
    canonical_code_table,
)
from huffman_tpu_torch.io import read_container, write_container
from huffman_tpu_torch.ops import decode as td
from huffman_tpu_torch.ops import encode as tenc
from huffman_tpu_torch.ops import encode_map_kernels as em
from huffman_tpu_torch.ops import gap_decode_kernels as gd
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk
from huffman_tpu_torch.ops import tables as tt


def _tables(lengths, max_len=16):
    """(JAX table, port table) of one length profile."""
    return jcct(lengths, max_len), canonical_code_table(lengths, max_len)


def _fit(data, max_len=16):
    return _tables(jpml(jnpref.histogram(data), max_len), max_len)


def _table_case(kind):
    if kind == "max_len=16":
        # geometric frequencies: package-merge clamps the deepest codes at 16
        freqs = np.zeros(256, np.int64)
        freqs[:20] = 2 ** np.arange(20, 0, -1)
        return _tables(jpml(freqs, 16))
    if kind == "one symbol":
        return _fit(np.full(5000, 7, np.uint8))
    if kind == "uniform":  # every code 8 bits: no code past the L1 prefix
        return _fit(np.arange(5000, dtype=np.uint8))
    return _fit(generate_redundant(20_000, float(kind), seed=1))


# ----------------------------------------------------------------------
# Decode tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["0.1", "0.5", "max_len=16", "one symbol",
                                  "uniform"])
def test_decode_tables_match(kind):
    jt, pt = _table_case(kind)
    for a, b in zip(build_flat_lut(pt), jbuild_flat_lut(jt)):
        assert np.array_equal(a, b)
    p = tt._two_level_prefix(pt)
    jtwo, ptwo = jbuild_two_level(jt, p), build_two_level_table(pt, p)
    for f in ("prefix_bits", "boundary_code", "l1_sym", "l1_len", "ptr_table",
              "l2_sym", "l2_len"):
        a, b = getattr(ptwo, f), getattr(jtwo, f)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, f
    assert tt._two_level_boundary(pt, p) == ptwo.boundary_code
    if kind == "uniform":
        assert ptwo.boundary_code == 1 << p
    if kind == "max_len=16":
        assert pt.max_len_present == 16
    assert tt.dec_spec(pt).__dict__ == jdec_spec(jt).__dict__
    for two_level in (True, False):
        jdec = jdevice_dec_table(jt, two_level=two_level)
        pdec = tt.device_dec_table(pt, two_level=two_level, device="cpu")
        # the JAX package's eleven fields, the kernels' four first
        assert set(pdec._fields) == set(jdec._fields)
        assert pdec._fields[:4] == ("lim_left", "offsets", "first_code",
                                    "symtab")
        for f in jdec._fields:
            assert np.array_equal(getattr(pdec, f).numpy(),
                                  np.asarray(getattr(jdec, f)).astype(np.int64)), f


# ----------------------------------------------------------------------
# Step decoders
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def stream():
    data = generate_redundant(20_000, 0.5, seed=7)
    jt, pt = _fit(data)
    return data, jt, pt


@pytest.mark.parametrize("seg_bits", [128, 1024])
@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
def test_step_decoders_match(stream, method, seg_bits):
    data, jt, pt = stream
    words, total_bits = npref.encode_bits(data, pt)
    gaps, counts, _ = npref.segment_metadata(data, pt, seg_bits)
    gaps = gaps.astype(np.int32)
    mc = int(counts.max())
    jdec, jspec = jdevice_dec_table(jt), jdec_spec(jt)
    pdec, pspec = tt.device_dec_table(pt, device="cpu"), tt.dec_spec(pt)
    jw, jg = jnp.asarray(words), jnp.asarray(gaps)
    pw, pg = torch.from_numpy(words.view(np.int32)), torch.from_numpy(gaps)
    ref = jdecode_block(jw, jg, jnp.asarray(counts), jdec, spec=jspec,
                        seg_bits=seg_bits, max_count=mc, out_size=data.size,
                        method=method)
    got = td.decode_block(pw, pg, torch.from_numpy(counts), pdec, spec=pspec,
                          seg_bits=seg_bits, max_count=mc, out_size=data.size,
                          method=method)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), data)
    kw = dict(seg_bits=seg_bits, max_count=mc + 8, method=method)
    ref = jcount_segments(jw, jg, jnp.int32(total_bits), jdec, spec=jspec, **kw)
    got = td.count_segments(pw, pg, total_bits, pdec, spec=pspec, **kw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), counts)


def test_step_decoder_errors_match(stream):
    data, jt, pt = stream
    words, _ = npref.encode_bits(data, pt)
    gaps, counts, _ = npref.segment_metadata(data, pt, 1024)
    jargs = (jnp.asarray(words), jnp.asarray(gaps.astype(np.int32)),
             jnp.asarray(counts))
    pargs = (torch.from_numpy(words.view(np.int32)),
             torch.from_numpy(gaps.astype(np.int32)), torch.from_numpy(counts))
    kw = dict(seg_bits=1024, max_count=int(counts.max()), out_size=data.size)
    for method, two_level in (("bogus", True), ("twolevel", False)):
        with pytest.raises(ValueError) as jerr:
            jdecode_block(*jargs, jdevice_dec_table(jt, two_level=two_level),
                          spec=jdec_spec(jt), method=method, **kw)
        with pytest.raises(ValueError) as perr:
            td.decode_block(*pargs, tt.device_dec_table(
                pt, two_level=two_level, device="cpu"),
                            spec=tt.dec_spec(pt), method=method, **kw)
        assert str(perr.value) == str(jerr.value)
        with pytest.raises(ValueError, match=str(jerr.value)[:30]):
            td.count_segments(pargs[0], pargs[1], 32 * words.size,
                              tt.device_dec_table(pt, two_level=two_level,
                                                  device="cpu"),
                              spec=tt.dec_spec(pt), seg_bits=1024, max_count=4,
                              method=method)


# ----------------------------------------------------------------------
# B5 and encode_block_fast
# ----------------------------------------------------------------------
def test_encode_map_plain_matches_pallas():
    # 6 blocks of 4096 bytes; the table lacks the bytes >= 200, and one
    # group holds only those (its length is 0: the kernel's guarded shift)
    data = generate_redundant(24_576, 0.5, seed=9)
    jt, pt = _fit(np.where(data >= 200, 65, data).astype(np.uint8))
    data[100:104] = [200, 201, 250, 255]
    data[5000] = 230
    ref = encode_map_pallas(jnp.asarray(data), jk.ils_enc_tabs(jt),
                            interpret=True)
    got = em.encode_map(torch.from_numpy(data), tk.ils_enc_tabs(pt, device="cpu"))
    assert em.launch_counts()["encode_map"] == 0  # a CPU tensor runs the plain version
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64)
                              .astype(np.uint32).view(np.int32))
    assert int(got[2][25]) == 0 and int(got[0][25]) == 0


@pytest.mark.parametrize("seg_bits", [128, 1024])
@pytest.mark.parametrize("gen", ["0.5", "0.9", "binomial"])
def test_encode_block_fast_matches_encode_block(gen, seg_bits):
    n = 8192 * 3
    data = (generate_binomial(n, seed=12) if gen == "binomial"
            else generate_redundant(n, float(gen), seed=10))
    jt, pt = _fit(data)
    total = int(jt.lengths.astype(np.int64)[data].sum())
    kw = dict(seg_bits=seg_bits, max_words=-(-total // 32),
              n_segs=max(-(-total // seg_bits), 1))
    ref = jencode_block(jnp.asarray(data), jdevice_enc_table(jt), **kw)
    enc = tk.ils_enc_tabs(pt, device="cpu")
    got = tenc.encode_block_fast(torch.from_numpy(data), enc, **kw)
    assert int(got[1]) == int(ref[1]) == total
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(ref[0]))
    for g, r in zip(got[2:], ref[2:]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    # and the port's own encode_block, the tests' oracle
    for g, r in zip(got, tenc.encode_block(torch.from_numpy(data), enc, **kw)):
        assert torch.equal(g, r)


def test_encode_block_fast_needs_whole_4096_byte_rows():
    data = torch.zeros(4096 + 128, dtype=torch.uint8)
    _, pt = _fit(np.arange(256, dtype=np.uint8))
    with pytest.raises(ValueError, match="multiple of 4096"):
        tenc.encode_block_fast(data, tk.ils_enc_tabs(pt, device="cpu"), seg_bits=1024,
                               max_words=1024, n_segs=32)
    with pytest.raises(ValueError, match="multiple of 4096"):
        em.encode_map(data, tk.ils_enc_tabs(pt, device="cpu"))


# ----------------------------------------------------------------------
# GapArrayCodec(method=...) and decode_yamamoto(method=...)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", [None, "pallas", "lut", "canonical",
                                    "twolevel"])
def test_gap_codec_methods_round_trip(method):
    data = generate_redundant(3 * 4096 + 777, 0.5, seed=13)
    kw = dict(block_bytes=4096, seg_bits=256, device="cpu")
    codec = GapArrayCodec.fit(data, method=method, **kw)
    assert codec.method == (method or "pallas")
    assert (codec.dec.l1_sym.numel() > 1) == (method == "twolevel")
    blob = write_container(codec.encode(data))
    out = codec.decode(read_container(blob))
    assert np.array_equal(out.numpy(), data)
    assert torch.equal(out, GapArrayCodec.fit(data, **kw).decode(
        read_container(blob)))
    blocks = data[: 3 * 4096].reshape(3, 4096)
    dev_out = codec.decode_device(codec.encode_device(blocks))
    assert np.array_equal(dev_out.numpy(), blocks)


def test_gap_codec_unknown_method_raises_on_decode():
    data = generate_redundant(4096, 0.5, seed=14)
    codec = GapArrayCodec.fit(data, block_bytes=4096, method="bogus",
                              device="cpu")
    comp = codec.encode(data)  # encode does not read the method
    with pytest.raises(ValueError, match="unknown decode method: bogus"):
        codec.decode(comp)


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
def test_decode_yamamoto_methods_match(method):
    data = generate_redundant(5000, 0.5, seed=3)
    _, pt = _fit(data)
    blob = write_yamamoto(data, pt)
    if method == "twolevel":  # the reference's own fault, kept (ROADMAP F8)
        with pytest.raises(ValueError) as jerr:
            jdecode_yamamoto(blob, method=method)
        with pytest.raises(ValueError) as perr:
            decode_yamamoto(blob, method=method, device="cpu")
        assert str(perr.value) == str(jerr.value)
        return
    got = decode_yamamoto(blob, method=method, device="cpu")
    assert np.array_equal(got.numpy(), jdecode_yamamoto(blob, method=method))
    assert np.array_equal(got.numpy(), data)


# ----------------------------------------------------------------------
# D1: the streaming fused pack on A2's kernel
# ----------------------------------------------------------------------
def _ils_case(n_tiles, k, seed):
    data = generate_redundant(n_tiles * k * ILS_LANES, 0.5, seed=seed)
    jt, pt = _fit(data)
    avg = float(jt.lengths.astype(np.int64)[data].mean())
    words = np.ascontiguousarray(data).view(np.int32)
    return (data, jt, pt, ils_schedule_numer(avg), avg,
            jnp.asarray(words.reshape(-1, 8, 128)),
            torch.from_numpy(words.reshape(-1, ILS_LANES).copy()))


def _stream_contract(ref, got, stride_rows, n_tiles):
    """tests/test_ils.py::test_stream_pack_matches_fused's contract: bits,
    envelopes and flags equal, each tile's rows [0, w_tile) equal, the
    trailing slack zero."""
    for name, a, b in zip(("bits", "dec_min", "dec_max", "viol"), ref[1:],
                          got[1:]):
        assert np.array_equal(np.asarray(a).reshape(b.shape), b.numpy()), name
    pay_ref = np.asarray(ref[0]).reshape(-1, ILS_LANES)
    pay_got = got[0].numpy()
    bits = got[1].numpy()
    for t in range(n_tiles):
        w_t = 2 * (-(-int(bits[t].max()) // 64))
        lo = t * stride_rows
        assert np.array_equal(pay_ref[lo : lo + w_t], pay_got[lo : lo + w_t]), t
    assert not pay_got[n_tiles * stride_rows :].any()


@pytest.mark.parametrize("anchor", ["mu", "laggard"])
def test_stream_pack_matches_jax(anchor):
    k, stride_rows = 256, 128
    _, jt, pt, snum, _, jwords, pwords = _ils_case(2, k, 21)
    kw = dict(k=k, stride_rows=stride_rows, chunk_cap=8, anchor=anchor)
    ref = jk.ils_pack_certify_stream(jwords, jnp.asarray([snum, 0], jnp.int32),
                                     jk.ils_enc_tabs(jt), interpret=True, **kw)
    enc = tk.ils_enc_tabs(pt, device="cpu")
    got = tk.ils_pack_certify_stream(pwords, snum, enc, **kw)
    _stream_contract(ref, got, stride_rows, 2)
    plain = tk.ils_pack_certify_stream_plain(pwords, snum, enc, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    # the same function as A2 at this shape
    a2 = tk.ils_pack_certify(pwords, snum, enc, k=k, stride_rows=stride_rows,
                             anchor=anchor)
    assert all(torch.equal(a, b) for a, b in zip(got, a2))


def test_stream_pack_flush_cadence_follows_chunk_cap():
    # k=96 chunks 24 bodies at the default cap (G = 2) but 3 at chunk_cap=3
    # (G = 1): the stream's flags follow its own cadence (trap F2)
    k, stride_rows, e_band = 96, 48, 8
    assert tk.flush_group(k, e_band) == 2
    assert tk.flush_group(k, e_band, chunk_cap=3) == 1
    _, jt, pt, snum, _, jwords, pwords = _ils_case(2, k, 23)
    kw = dict(k=k, stride_rows=stride_rows, chunk_cap=3, e_band=e_band)
    ref = jk.ils_pack_certify_stream(jwords, jnp.asarray([snum, 0], jnp.int32),
                                     jk.ils_enc_tabs(jt), interpret=True, **kw)
    got = tk.ils_pack_certify_stream(pwords, snum,
                                     tk.ils_enc_tabs(pt, device="cpu"), **kw)
    _stream_contract(ref, got, stride_rows, 2)


def test_stream_pack_not_viable_raises():
    _, jt, pt, snum, _, jwords, pwords = _ils_case(1, 64, 24)
    assert tk.ils_stream_span_rows(64, 32) is None  # one chunk
    assert jk.ils_stream_span_rows(64, 32) is None
    for k, cap in ((64, tk.CHUNK_I), (256, 8)):
        for span_args in ((k, 32), (k, 128, 32, cap)):
            assert tk.ils_stream_span_rows(*span_args) \
                == jk.ils_stream_span_rows(*span_args)
    with pytest.raises(ValueError, match="streaming pack not viable"):
        tk.ils_pack_certify_stream(pwords, snum,
                                   tk.ils_enc_tabs(pt, device="cpu"), k=64,
                                   stride_rows=32)
    with pytest.raises(ValueError, match="flush_g must be 1 or 2"):
        tk.ils_pack_certify_stream(pwords, snum,
                                   tk.ils_enc_tabs(pt, device="cpu"), k=64,
                                   stride_rows=32, flush_g=3)


def test_encode_streaming_tier_matches_jax(monkeypatch):
    # tests/test_ils.py::test_encode_stream_roundtrip's setting: stride 128
    # rows over a budget of 100, span 92 rows at chunk_cap=8 under it
    k = 256
    data, jt, pt, _, avg, jwords, pwords = _ils_case(3, k, 22)
    monkeypatch.setattr(jils, "FUSED_STRIDE_BUDGET", 100)
    monkeypatch.setattr(jils, "PREFER_STREAM_PACK", True)
    monkeypatch.setattr(jils, "_STREAM_CHUNK_CAP", 8)
    jrows, _, jp = jils.ils_encode_to_device(
        jwords, jk.ils_enc_tabs(jt), k=k, avg_bits=avg, max_len=16,
        interpret=True)
    monkeypatch.setattr(tils, "PREFER_STREAM_PACK", True)
    monkeypatch.setattr(tils, "_STREAM_CHUNK_CAP", 8)
    for name in ("ils_pack_certify", "ils_lengths_pass", "ils_pack"):
        monkeypatch.setattr(tils, name, lambda *a, name=name, **kw: pytest.fail(
            f"{name} must not run"))
    rows, _, p = tils.ils_encode_to_device(
        pwords, tk.ils_enc_tabs(pt, device="cpu"), k=k, avg_bits=avg, max_len=16,
        stride_budget=100)
    for f in ("k", "snum", "w_band", "w_cap", "n_tiles", "rot"):
        assert getattr(p, f) == getattr(jp, f), f
    for f in ("boffs", "w_tiles"):
        assert np.array_equal(getattr(p, f), getattr(jp, f)), f
    assert np.array_equal(rows[: p.total_rows].numpy(),
                          np.asarray(jrows).reshape(-1, ILS_LANES)[: p.total_rows])


# ----------------------------------------------------------------------
# D3: the chunk-shared placement is B2's function
# ----------------------------------------------------------------------
def test_chunked_placement_matches_b2():
    # tests/test_compact.py::_pack_case at (40, 100, seed 1)
    rng = np.random.default_rng(1)
    n_segs, max_count = 40, 100
    counts = rng.integers(0, max_count + 1, n_segs)
    counts[rng.random(n_segs) < 0.1] = 0
    segs = [rng.integers(0, 256, c).astype(np.uint8) for c in counts]
    out_rows = -(-max_count // 4)
    padded = np.zeros((n_segs, out_rows * 4), np.uint8)
    for s, seg in enumerate(segs):
        padded[s, : seg.size] = seg
    packed = padded.view("<u4").astype(np.uint32).T.view(np.int32)
    symtab = rng.permutation(256).astype(np.uint8)
    expect = symtab[np.concatenate(segs)]
    assert plan_compact(counts.astype(np.int64), expect.size).statics.w_f > 0
    ref = compact_ranks_device(jnp.asarray(packed), counts, symtab, expect.size,
                               chunked=True, interpret=True)
    # the TPU's LSB-first transposed rank words back into B2's rank rows
    ranks = torch.from_numpy(np.ascontiguousarray(packed.T).view(np.uint8))
    flat = torch.from_numpy(counts.astype(np.int32))
    offsets = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    got = gd.gap_place_bytes(ranks, flat, offsets,
                             torch.from_numpy(symtab.astype(np.int32)),
                             n_out=expect.size)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), expect)
