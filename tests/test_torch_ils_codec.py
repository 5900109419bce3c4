"""The ILS codec of the PyTorch port against the JAX package, on the CPU.

The port runs with device="cpu" (its kernels' plain PyTorch versions); the
JAX package runs its Pallas kernels in interpret mode at the JAX suite's
tiny shapes.  Policy, section parameters (w_cap included), payloads and
container bytes must be equal, decoding must cross both ways, and bad input
must raise the same errors.
"""

import dataclasses

import numpy as np
import pytest
import torch

import huffman_tpu.ops.ils as jils
from huffman_tpu.core.ils_ref import ILS_LANES
from huffman_tpu.io import read_ils_container as jread
from huffman_tpu.io import write_ils_container as jwrite
from huffman_tpu.models import IlsCodec as JCodec
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch import IlsCodec
from huffman_tpu_torch.io import (
    code_table_from_numpy,
    read_ils_container,
    section_from_numpy,
    write_ils_container,
)
from huffman_tpu_torch.ops import ils as tils


def _codecs(data, k, rotate="auto"):
    return (JCodec.fit(data, k=k, interpret=True, rotate=rotate),
            IlsCodec.fit(data, k=k, device="cpu", rotate=rotate))


def _to_port(jcomp):
    from huffman_tpu_torch.models.ils_codec import IlsCompressed

    t = jcomp.table
    return IlsCompressed(
        table=code_table_from_numpy(t.lengths, t.max_len),
        original_size=jcomp.original_size,
        sections=[
            section_from_numpy(s.params.k, s.params.snum, s.params.boffs,
                               s.params.w_band, s.params.w_cap,
                               s.params.w_tiles, s.params.n_tiles,
                               s.params.rot, s.payload)
            for s in jcomp.sections
        ],
    )


def _same_params(jp, tp):
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name


# ----------------------------------------------------------------------
# Format policy: the JAX package's functions over a grid of inputs
# ----------------------------------------------------------------------
def test_policy_constants_match():
    for name in ("_BAND_BUCKETS", "_CAP_BUCKETS", "VMEM_ROW_BUDGET", "MIN_K",
                 "FUSED_STRIDE_BUDGET"):
        assert getattr(tils, name) == getattr(jils, name), name
    assert tils.FUSED_E_BAND == jils.FUSED_E_BAND


def test_policy_functions_match_over_grid():
    for v in range(0, 3000, 7):
        assert tils.round_band(v) == jils.round_band(v)
        assert tils.round_cap(v) == jils.round_cap(v)
    for k in (8, 12, 48, 256, 1024, 2048, 4096, 8192, 16384, 65536):
        assert tils.fused_e_band(k) == jils.fused_e_band(k)
        assert tils.auto_rot_band(k) == jils.auto_rot_band(k)
    for avg in np.linspace(0.5, 16.0, 63):
        for opt in ("speed", "ratio"):
            assert tils.pick_k(avg, opt) == jils.pick_k(avg, opt)


@pytest.mark.parametrize("k,w_tiles,dmax,extra", [
    (2048, [64], 100, 0), (2048, [32], 4, 96), (4096, [64, 120], 30, 0),
    (4096, [64], 3000, 0), (8192, [1500], 10, 0), (2048, [64], 3000, 0),
    (16384, [2700], 2, 900), (12, [4, 6], 1, 8),
])
def test_certify_params_match(k, w_tiles, dmax, extra):
    n = len(w_tiles)
    kw = dict(k=k, snum=1 << 16, n_tiles=n, w_tiles=np.array(w_tiles, np.int64),
              dec_min=np.zeros((n, 2), np.int32),
              dec_max=np.full((n, 2), dmax, np.int32), extra_band_pairs=extra)
    kw["dec_max"][0, 1] = -(1 << 30)  # an empty window keeps boff 0
    kw["dec_min"][0, 1] = 1 << 30
    try:
        ref = jils.certify_params(**kw)
    except jils.IlsVmemError as e:
        with pytest.raises(tils.IlsVmemError, match="VMEM row budget") as got:
            tils.certify_params(**kw)
        assert str(got.value) == str(e)
        return
    _same_params(ref, tils.certify_params(**kw))


# ----------------------------------------------------------------------
# ils_encode_device: every tier
# ----------------------------------------------------------------------
def _section_pair(data, k, rot, **port_kw):
    jc, tc = _codecs(data, k)
    avg = float(jc.table.lengths.astype(np.int64)[data].mean())
    jsec = jils.ils_encode_device(data, jc.table, jc.enc, k=k, avg_bits=avg,
                                  rot=rot, interpret=True)
    tsec = tils.ils_encode_device(data, tc.table, tc.enc, k=k, avg_bits=avg,
                                  rot=rot, device="cpu", **port_kw)
    return jsec, tsec


@pytest.mark.parametrize("r,rot", [(0.5, False), (0.9, True), (0.5, "auto")])
def test_encode_device_fused_matches(r, rot):
    k = 64  # stride 32 rows: the fused tier
    data = generate_redundant(2 * k * ILS_LANES, r, seed=31)
    jsec, tsec = _section_pair(data, k, rot)
    _same_params(jsec.params, tsec.params)
    assert np.array_equal(jsec.payload, tsec.payload_u32())


def test_encode_device_two_pass_matches(monkeypatch):
    # the fused gate off in both packages: JAX by its module constant, the
    # port by argument
    monkeypatch.setattr(jils, "FUSED_STRIDE_BUDGET", 0)
    k = 12
    data = generate_redundant(2 * k * ILS_LANES, 0.5, seed=4)
    jsec, tsec = _section_pair(data, k, False, stride_budget=0)
    _same_params(jsec.params, tsec.params)
    assert np.array_equal(jsec.payload, tsec.payload_u32())


def test_encode_device_laggard_tier_matches(monkeypatch):
    # zeros-then-uniform at e_band=8: "mu" violates, "laggard" certifies,
    # the two-pass tier must not run in either package
    k = 256
    n = k * ILS_LANES
    data = np.zeros(n, np.uint8)
    data[n // 2:] = generate_redundant(n // 2, 0.0, seed=17)
    import huffman_tpu_torch.ops.ils as port_ils

    for mod in (jils, port_ils):
        monkeypatch.setattr(mod, "fused_e_band", lambda k: 8)
    monkeypatch.setattr(jils, "ils_lengths_pass",
                        lambda *a, **kw: pytest.fail("JAX two-pass ran"))
    monkeypatch.setattr(port_ils, "ils_lengths_pass",
                        lambda *a, **kw: pytest.fail("port two-pass ran"))
    jsec, tsec = _section_pair(data, k, False)
    _same_params(jsec.params, tsec.params)
    assert np.array_equal(jsec.payload, tsec.payload_u32())


def _skewed_stream(k):
    # every rare symbol sprinkled (long codes), stream 5 all rare bytes: its
    # schedule drifts far from every other stream's
    n = k * ILS_LANES
    data = np.zeros(n, np.uint8)
    rare = np.arange(1, 256, dtype=np.uint8)
    data[::129] = rare[np.arange((n + 128) // 129) % 255]
    u32_idx = np.arange(5, n // 4, ILS_LANES)
    byte_idx = (u32_idx[:, None] * 4 + np.arange(4)[None]).reshape(-1)
    data[byte_idx] = rare[np.arange(byte_idx.size) % 255]
    return data


def test_encode_device_violation_falls_to_two_pass(monkeypatch):
    # at e_band=2 both anchors violate on the skewed stream, so the section
    # comes from the two-pass tier in both packages (trap F2: its extra
    # emission band may widen w_cap, which must match too)
    import huffman_tpu_torch.ops.ils as port_ils

    ran = []
    real = port_ils.ils_pack
    monkeypatch.setattr(port_ils, "ils_pack",
                        lambda *a, **kw: ran.append(1) or real(*a, **kw))
    for mod in (jils, port_ils):
        monkeypatch.setattr(mod, "fused_e_band", lambda k: 2)
    data = _skewed_stream(128)
    jsec, tsec = _section_pair(data, 128, False)
    assert ran == [1]
    _same_params(jsec.params, tsec.params)
    assert np.array_equal(jsec.payload, tsec.payload_u32())


# ----------------------------------------------------------------------
# IlsCodec and the ILS1 container
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_extra", [0, 1, 4095, 4096])
def test_container_bytes_match_and_cross_decode(n_extra):
    k = 8
    data = generate_redundant(k * ILS_LANES + n_extra, 0.5, seed=5)
    jc, tc = _codecs(data, k)
    jblob = jwrite(jc.encode(data))
    tcomp = tc.encode(data)
    tblob = write_ils_container(tcomp)
    assert tblob == jblob
    assert len(tblob) == tcomp.compressed_bytes
    # port reads JAX's bytes, JAX reads the port's
    assert np.array_equal(tc.decode(read_ils_container(jblob)).numpy(), data)
    assert np.array_equal(jc.decode(jread(tblob)), data)
    # sections carried across in memory (io/convert.py)
    assert np.array_equal(tc.decode(_to_port(jc.encode(data))).numpy(), data)


def test_empty_input_matches():
    data = np.zeros(0, np.uint8)
    jc, tc = _codecs(data, 8)
    tcomp = tc.encode(data)
    assert write_ils_container(tcomp) == jwrite(jc.encode(data))
    assert tc.decode(tcomp).numel() == 0


@pytest.mark.parametrize("rotate", [False, True, "auto"])
def test_rotation_container_matches(rotate):
    # lane-periodic content: rotation narrows the band, so "auto" rotates
    k = 64
    period = np.frombuffer(np.random.default_rng(0).bytes(4096), np.uint8).copy()
    period.reshape(8, 512)[::2] = 0
    data = np.tile(period, 2 * k * ILS_LANES // 4096)
    jc, tc = _codecs(data, k, rotate=rotate)
    jblob, tblob = jwrite(jc.encode(data)), write_ils_container(tc.encode(data))
    assert tblob == jblob
    assert tblob[4] == (3 if rotate is False else 4)
    assert np.array_equal(tc.decode(read_ils_container(jblob)).numpy(), data)


def test_codec_multi_section_and_roundtrip(monkeypatch):
    k = 8
    data = generate_redundant(5 * k * ILS_LANES + 100, 0.5, seed=10)
    jc, tc = _codecs(data, k)
    monkeypatch.setattr(JCodec, "SECTION_BYTES", 2 * k * ILS_LANES)
    monkeypatch.setattr(IlsCodec, "SECTION_BYTES", 2 * k * ILS_LANES)
    tcomp = tc.encode(data)
    assert len(tcomp.sections) == 4
    assert write_ils_container(tcomp) == jwrite(jc.encode(data))
    assert tc.roundtrip_check(data)
    assert tc.roundtrip_check(torch.from_numpy(data))


def test_k_halves_on_row_budget_like_jax(monkeypatch):
    # the JAX suite's retry case: a shrunken row budget makes the skewed
    # stream overflow at k=16, so both codecs halve k the same way
    for mod in (jils, tils):
        monkeypatch.setattr(mod, "VMEM_ROW_BUDGET", 8)
        monkeypatch.setattr(mod, "MIN_K", 8)
    k = 16
    data = _skewed_stream(k)
    jc, tc = _codecs(data, k)
    tcomp = tc.encode(data)
    assert all(s.params.k < k for s in tcomp.sections)
    assert write_ils_container(tcomp) == jwrite(jc.encode(data))
    assert np.array_equal(tc.decode(tcomp).numpy(), data)


def _row_budget_16(monkeypatch):
    for mod in (jils, tils):
        monkeypatch.setattr(mod, "VMEM_ROW_BUDGET", 16)
        monkeypatch.setattr(mod, "MIN_K", 8)


def test_k_halving_rounds_up_to_a_multiple_of_4(monkeypatch):
    # k = 4 * 51 over the row budget: plain halving gives 102, which is no
    # multiple of 4 (the JAX package writes sections of k=51 that decode
    # short); the port takes 104, then 52, and its container decodes in
    # both packages
    _row_budget_16(monkeypatch)
    data = generate_redundant(2 * 204 * ILS_LANES + 5, 0.5, seed=3)
    tc = IlsCodec.fit(data, k=204, device="cpu")
    tcomp = tc.encode(data)
    assert [s.params.k for s in tcomp.sections] == [52, 48]
    assert np.array_equal(tc.decode(tcomp).numpy(), data)
    blob = write_ils_container(tcomp)
    assert np.array_equal(tc.decode(read_ils_container(blob)).numpy(), data)
    jc = JCodec(jread(blob).table, interpret=True)
    assert np.array_equal(np.asarray(jc.decode(jread(blob))), data)


def test_k_halving_keeps_jax_bytes_where_the_half_is_a_multiple_of_4(
        monkeypatch):
    _row_budget_16(monkeypatch)
    data = generate_redundant(208 * ILS_LANES + 5, 0.5, seed=3)
    jc, tc = _codecs(data, 208)
    tcomp = tc.encode(data)
    assert [s.params.k for s in tcomp.sections] == [52, 8]
    assert write_ils_container(tcomp) == jwrite(jc.encode(data))
    assert np.array_equal(tc.decode(tcomp).numpy(), data)


# ----------------------------------------------------------------------
# Errors
# ----------------------------------------------------------------------
def _blob(rotate=False, k=8):
    data = generate_redundant(k * ILS_LANES, 0.5, seed=13)
    return IlsCodec.fit(data, k=k, device="cpu", rotate=rotate), data


def _same_error(buf):
    with pytest.raises(ValueError) as ref:
        jread(buf)
    with pytest.raises(ValueError) as got:
        read_ils_container(buf)
    assert str(got.value) == str(ref.value)


def test_container_errors_match():
    codec, data = _blob()
    blob = bytearray(write_ils_container(codec.encode(data)))
    _same_error(b"NOPE" + b"\x00" * 64)
    bad = bytearray(blob)
    bad[-5] ^= 0x40  # payload bit flip
    _same_error(bytes(bad))
    off = 21 + 2 * codec.table.num_symbols + 8  # flags word of section 0
    for flag in (0x02, 0x01):
        bad = bytearray(blob)
        bad[off] = flag
        _same_error(bytes(bad))
    bad = bytearray(blob)
    bad[4] = 5  # version
    _same_error(bytes(bad))
    _same_error(bytes(blob[:-8]))  # truncated payload
    _same_error(bytes(blob) + b"\x00")  # trailing bytes


def test_invalid_band_error_matches():
    codec, data = _blob()
    sec = codec.encode(data).sections[0]
    p = dataclasses.replace(sec.params, w_band=sec.params.w_cap // 2 + 1)
    jt = JCodec.fit(data, k=8, interpret=True)
    jsec = jils.IlsSection(
        params=jils.IlsParams(**dataclasses.asdict(p)),
        payload=sec.payload_u32())
    with pytest.raises(ValueError, match="w_band") as ref:
        jils.ils_decode_device(jsec, jt.table, jt.dec, interpret=True)
    with pytest.raises(ValueError, match="w_band") as got:
        tils.ils_decode_device(tils.IlsSection(p, sec.payload), codec.table,
                               codec.dec, device="cpu")
    assert str(got.value) == str(ref.value)
