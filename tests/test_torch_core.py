"""The port's own copies of the JAX package's host modules, held to them.

`huffman_tpu_torch` keeps its own copies of the table math, the ILS layout
helpers and the data generator (it imports nothing of `huffman_tpu`).  They
decide the container bytes, so each must give exactly what the JAX
package's module gives on the same seeded NumPy inputs, errors included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from huffman_tpu import constants as jconst
from huffman_tpu.core import canonical as jcan
from huffman_tpu.core import ils_ref as jref
from huffman_tpu.core import npref as jnpref
from huffman_tpu.core import package_merge as jpm
from huffman_tpu.utils import datagen as jgen
from huffman_tpu_torch import constants as tconst
from huffman_tpu_torch.core import canonical as tcan
from huffman_tpu_torch.core import ils_ref as tref
from huffman_tpu_torch.core import npref as tnpref
from huffman_tpu_torch.core import package_merge as tpm
from huffman_tpu_torch.utils import datagen as tgen


def _freqs(seed):
    """Seeded histograms: sparse, dense, skewed (long codes) and tiny."""
    rng = np.random.default_rng(seed)
    f = np.zeros(256, np.int64)
    kind = seed % 4
    if kind == 0:
        f[rng.choice(256, 5, replace=False)] = rng.integers(1, 1000, 5)
    elif kind == 1:
        f[:] = rng.integers(0, 1 << 20, 256)
    elif kind == 2:
        f[:] = (2.0 ** rng.uniform(0, 40, 256)).astype(np.int64)
    else:
        f[rng.integers(0, 256)] = 7
    return f


def test_constants_match():
    for name in ("MAX_CODEWORD_LENGTH", "ALPHABET_SIZE"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for name in ("ILS_LANES", "ILS_WIN", "ILS_ROT_SUB", "ILS_ROT_LANE"):
        assert getattr(tref, name) == getattr(jref, name), name


@pytest.mark.parametrize("max_len", [8, 11, 16])
def test_package_merge_matches(max_len):
    for seed in range(24):
        f = _freqs(seed)
        if np.count_nonzero(f) > (1 << max_len):
            continue
        assert np.array_equal(tpm.package_merge_lengths(f, max_len),
                              jpm.package_merge_lengths(f, max_len)), seed
    assert not tpm.package_merge_lengths(np.zeros(256, np.int64)).any()


@pytest.mark.parametrize("freqs,max_len", [
    (np.zeros(255, np.int64), 16),
    (np.r_[-1, np.ones(255, np.int64)], 16),
    (np.ones(256, np.int64), 7),
])
def test_package_merge_errors_match(monkeypatch, freqs, max_len):
    # the port copies the NumPy path; the JAX package's optional native
    # path words one of these errors differently
    from huffman_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError) as ref:
        jpm.package_merge_lengths(freqs, max_len)
    with pytest.raises(ValueError) as got:
        tpm.package_merge_lengths(freqs, max_len)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("max_len", [8, 12, 16])
def test_canonical_table_matches(max_len):
    for seed in range(24):
        f = _freqs(seed)
        if np.count_nonzero(f) > (1 << max_len):
            continue
        lengths = jpm.package_merge_lengths(f, max_len)
        jt = jcan.canonical_code_table(lengths, max_len)
        tt = tcan.canonical_code_table(lengths, max_len)
        for field in dataclasses.fields(tt):
            a, b = getattr(jt, field.name), getattr(tt, field.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field.name
            else:
                assert a == b, field.name
        for prop in ("num_symbols", "min_len", "max_len_present"):
            assert getattr(tt, prop) == getattr(jt, prop), prop
        assert tcan.chain_spec(tt) == jcan.chain_spec(jt)


@pytest.mark.parametrize("lengths,max_len", [
    (np.ones(255, np.uint8), 16),  # wrong shape
    (np.full(256, 9, np.uint8), 8),  # a length over max_len
    (np.r_[np.ones(3, np.uint8), np.zeros(253, np.uint8)], 16),  # Kraft
])
def test_canonical_table_errors_match(lengths, max_len):
    with pytest.raises(ValueError) as ref:
        jcan.canonical_code_table(lengths, max_len)
    with pytest.raises(ValueError) as got:
        tcan.canonical_code_table(lengths, max_len)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("size,kind", [
    pytest.param(0, "0.7", id="0"),
    pytest.param(1, "0.7", id="1"),
    pytest.param(4097, "0.7", id="4097"),
    pytest.param(1 << 17, "0.7", id="131072"),
    pytest.param(70_001, "0.9", id="70001-skewed"),
    pytest.param(65_537, "constant", id="65537-constant"),
    pytest.param(4099, "unaligned", id="4099-unaligned"),
])
def test_histogram_matches(size, kind):
    # a tensor is counted by `byte_counts` (its plain version on the CPU),
    # an array on the host; from an odd byte offset too
    from huffman_tpu_torch.ops.histogram_kernels import byte_counts

    if kind == "constant":
        data = np.full(size, 0x41, np.uint8)
    else:
        data = jgen.generate_redundant(
            size, 0.7 if kind == "unaligned" else float(kind), seed=size)
    t = torch.from_numpy(data)
    if kind == "unaligned":
        data, t = data[3:], t[3:]
    want = jnpref.histogram(data)
    assert np.array_equal(tnpref.histogram(data), want)
    got = tnpref.histogram(t)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    counts = byte_counts(t)
    assert counts.dtype == torch.int64 and counts.shape == (256,)
    assert np.array_equal(counts.numpy(), want)
    with pytest.raises(TypeError, match="uint8"):
        tnpref.histogram(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="uint8"):
        byte_counts(torch.zeros(4, dtype=torch.int8))


@pytest.mark.parametrize("size,r,seed", [
    (0, 0.5, 0), (1, 0.5, 1), (4095, 0.0, 2), (100_000, 0.9, 3),
    (65_537, 1.0, None), (5000, -0.5, 4), (5000, 1.5, 5),
])
def test_generate_redundant_matches(size, r, seed):
    got = tgen.generate_redundant(size, r, seed=seed)
    if seed is None:  # unseeded draws differ; only the shape is fixed
        assert got.shape == (size,) and got.dtype == np.uint8
        assert np.isin(got, np.frombuffer(b"ABCD", np.uint8)).all()
        return
    assert np.array_equal(got, jgen.generate_redundant(size, r, seed=seed))


def test_ils_layout_helpers_match():
    for k in (4, 8, 12, 64, 256, 260, 4096, 16384):
        assert tref.ils_n_win(k) == jref.ils_n_win(k)
    for k in (8, 12, 64, 4096):
        for inverse in (False, True):
            assert np.array_equal(tref._rot_src_index(k, inverse),
                                  jref._rot_src_index(k, inverse))
    for avg in np.linspace(0.0, 16.0, 97):
        assert tref.ils_schedule_numer(avg) == jref.ils_schedule_numer(avg)
    kw = dict(k=12, snum=123, boffs=np.zeros((3, 1), np.int32), w_band=8,
              w_cap=16, w_tiles=np.array([4, 6, 8], np.int32), n_tiles=3)
    jp, tp = jref.IlsParams(**kw), tref.IlsParams(**kw)
    assert np.array_equal(tp.row_starts, jp.row_starts)
    assert tp.row_starts.dtype == jp.row_starts.dtype
    assert tp.total_rows == jp.total_rows


# ----------------------------------------------------------------------
# The last host helpers: kraft_sum, huffman_lengths_unbounded, the two
# generators and the NumPy ILS oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("max_len", [8, 16])
def test_kraft_sum_matches(max_len):
    for seed in range(24):
        f = _freqs(seed)
        if np.count_nonzero(f) > (1 << max_len):
            continue
        lengths = tpm.package_merge_lengths(f, max_len)
        assert tpm.kraft_sum(lengths) == jpm.kraft_sum(lengths), seed
        assert tpm.kraft_sum(lengths) <= 1.0
    bad = np.r_[np.ones(3, np.uint8), np.zeros(253, np.uint8)]
    assert tpm.kraft_sum(bad) == jpm.kraft_sum(bad) == 1.5
    assert tpm.kraft_sum(np.zeros(256, np.uint8)) == 0.0


def test_huffman_lengths_unbounded_matches():
    for seed in range(32):
        f = _freqs(seed)
        got = tpm.huffman_lengths_unbounded(f)
        assert got.dtype == np.uint8
        assert np.array_equal(got, jpm.huffman_lengths_unbounded(f)), seed
    # a geometric skew drives the greedy tree past 16 bits
    f = (2.0 ** -np.arange(40) * 2 ** 41).astype(np.int64)
    f = np.r_[f, np.zeros(216, np.int64)]
    got = tpm.huffman_lengths_unbounded(f)
    assert got.max() > 16
    assert np.array_equal(got, jpm.huffman_lengths_unbounded(f))
    assert not tpm.huffman_lengths_unbounded(np.zeros(256, np.int64)).any()


@pytest.mark.parametrize("size,seed", [(0, 0), (1, 1), (4097, 2),
                                       (100_000, 3), (5000, None)])
def test_generate_binomial_and_single_symbol_match(size, seed):
    got = tgen.generate_binomial(size, seed=seed)
    assert got.shape == (size,) and got.dtype == np.uint8
    if seed is not None:
        assert np.array_equal(got, jgen.generate_binomial(size, seed=seed))
    for sym in (0, 65, 255):
        assert np.array_equal(tgen.generate_single_symbol(size, sym),
                               jgen.generate_single_symbol(size, sym))
    assert np.array_equal(tgen.generate_single_symbol(size),
                          jgen.generate_single_symbol(size))


def _oracle_case(seed, k, n_tiles):
    data = jgen.generate_redundant(n_tiles * k * 1024, (0.1, 0.5, 0.9)[seed % 3],
                                   seed=seed)
    table = tcan.canonical_code_table(
        tpm.package_merge_lengths(tnpref.histogram(data), 16), 16)
    jtable = jcan.canonical_code_table(table.lengths, 16)
    return data, table, jtable


@pytest.mark.parametrize("k,rot", [(8, False), (12, True), (64, False)])
def test_ils_stream_symbols_and_schedule_match(k, rot):
    data, table, _ = _oracle_case(k, k, 2)
    syms = tref.ils_stream_symbols(data, k, rot=rot)
    assert np.array_equal(syms, jref.ils_stream_symbols(data, k, rot=rot))
    lens = table.lengths[syms].astype(np.int64)
    for snum in (1, 40_000, jref.ils_schedule_numer(float(lens.mean())),
                 1 << 20):
        for got, want in zip(tref.ils_simulate_schedule(lens, snum),
                             jref.ils_simulate_schedule(lens, snum)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for bad_k, size in ((6, data.size), (0, data.size), (k, data.size - 4)):
        with pytest.raises(ValueError) as ref:
            jref.ils_stream_symbols(data[:size], bad_k)
        with pytest.raises(ValueError) as got:
            tref.ils_stream_symbols(data[:size], bad_k)
        assert str(got.value) == str(ref.value)


def test_ils_oracle_rounding_and_mu_match():
    for x in (0, 1, 8, 9, 24, 25, 300, 512, 513, 2000):
        assert tref._round_band(x) == jref._round_band(x), x
    # no 320/448/640 buckets in either oracle (the device path has them)
    for x in (0, 8, 9, 300, 320, 448, 640, 2048, 2049, 5000):
        assert tref._round_cap(x) == jref._round_cap(x), x
    # 64-bit mu: i * snum past 2^31 does not wrap
    for i, snum in ((0, 5), (65_535, 32_768), (3 << 20, 1 << 20)):
        assert int(tref._mu(i, snum)) == jref._mu(i, snum)
    i = np.arange(0, 1 << 22, 4099)
    assert np.array_equal(tref._mu(i, 1 << 20), jref._mu(i, 1 << 20))


@pytest.mark.parametrize("seed,k,n_tiles,rot", [
    (0, 8, 1, False), (1, 12, 2, True), (2, 16, 2, False), (4, 64, 1, True),
])
def test_ils_oracle_encode_decode_match(seed, k, n_tiles, rot):
    data, table, jtable = _oracle_case(seed, k, n_tiles)
    payload, params = tref.ils_encode_np(data, table, k, rot=rot)
    jpayload, jparams = jref.ils_encode_np(data, jtable, k, rot=rot)
    assert payload.dtype == jpayload.dtype
    assert np.array_equal(payload, jpayload)
    for f in dataclasses.fields(jparams):
        a, b = getattr(jparams, f.name), getattr(params, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    out = tref.ils_decode_np(payload, params, table)
    assert out.dtype == np.uint8 and np.array_equal(out, data)
    assert np.array_equal(jref.ils_decode_np(jpayload, jparams, jtable), out)


def test_ils_oracle_decodes_the_ports_sections():
    # the device path's w_cap buckets are finer than the oracle's (F1), yet
    # the oracle decodes each section of a container from its parameters
    from huffman_tpu_torch import IlsCodec

    data = jgen.generate_redundant(2 * 12 * 1024 + 77, 0.5, seed=9)
    codec = IlsCodec.fit(data, k=12, device="cpu")
    comp = codec.encode(data)
    outs = [tref.ils_decode_np(s.payload_u32(), s.params, comp.table)
            for s in comp.sections]
    assert np.array_equal(np.concatenate(outs)[: data.size], data)


def test_ils_oracle_errors_match():
    data, table, jtable = _oracle_case(5, 64, 1)
    # a symbol absent from the table
    sparse = tcan.canonical_code_table(
        tpm.package_merge_lengths(np.r_[1, np.zeros(255, np.int64)], 16), 16)
    with pytest.raises(ValueError) as ref:
        jref.ils_encode_np(data, jcan.canonical_code_table(sparse.lengths, 16), 64)
    with pytest.raises(ValueError) as got:
        tref.ils_encode_np(data, sparse, 64)
    assert str(got.value) == str(ref.value)
    # a band too narrow for the refills
    payload, params = tref.ils_encode_np(data, table, 64)
    narrow = dataclasses.replace(params, w_band=1,
                                 boffs=np.full_like(params.boffs, -50))
    jnarrow = jref.IlsParams(**dataclasses.asdict(narrow))
    with pytest.raises(ValueError) as ref:
        jref.ils_decode_np(payload, jnarrow, jtable)
    with pytest.raises(ValueError) as got:
        tref.ils_decode_np(payload, narrow, table)
    assert str(got.value) == str(ref.value)
