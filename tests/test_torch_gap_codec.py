"""The HTC1 codec of the PyTorch port against the JAX package, on the CPU.

The port runs with device="cpu" (its kernels' plain PyTorch versions); the
JAX package runs its Pallas encode in interpret mode.  Container bytes
must be equal, each package must decode what the other wrote, the device-
resident form must match in shapes and values, and bad containers must
raise the same errors.
"""

import numpy as np
import pytest
import torch

from huffman_tpu.io import container_kind as jkind
from huffman_tpu.io import read_container as jread
from huffman_tpu.io import write_container as jwrite
from huffman_tpu.models import GapArrayCodec as JCodec
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch import GapArrayCodec
from huffman_tpu_torch.core import npref
from huffman_tpu_torch.io import (
    compressed_from_numpy,
    container_kind,
    device_compressed_from_numpy,
    read_container,
    write_container,
)
from huffman_tpu_torch.models.gap_codec import Compressed


def _data(kind, n, seed=11):
    if kind == "single":
        return np.full(n, 9, np.uint8)
    return generate_redundant(n, float(kind), seed=seed)


def _to_port(jcomp):
    t = jcomp.table
    return compressed_from_numpy(
        t.lengths, t.max_len, jcomp.seg_bits, jcomp.original_size,
        jcomp.block_bytes, jcomp.block_words, jcomp.block_total_bits,
        jcomp.block_gaps, jcomp.block_counts)


# (content, size, block_bytes, seg_bits)
CASES = [
    ("0.1", 3 * 2048, 2048, 1024),
    ("0.5", 3 * 2048, 2048, 1024),
    ("0.9", 3 * 2048, 2048, 1024),
    ("0.5", 2 * 2048 + 777, 2048, 1024),  # ragged tail, not a multiple of 128
    ("0.5", 2 * 2048 + 1280, 2048, 1024),  # ragged tail, a multiple of 128
    ("0.5", 2000, 1000, 1024),  # blocks not a multiple of 128
    # a 128-byte tail at byte offset 1000 (8 mod 16) and 1001 (odd): the
    # kernel route gets a slice its int32 view and 16-byte loads cannot take
    ("0.5", 1128, 1000, 1024),
    ("0.5", 1129, 1001, 1024),
    # odd block sizes with ragged tails: every block through the kernels'
    # plain versions with its byte count (the JAX package: encode_block)
    ("0.5", 3 * 1000 + 7, 1000, 128),
    ("0.9", 2 * 129 + 5, 129, 1024),
    ("single", 3 * 127 + 1, 127, 128),
    ("0.1", 2 * 4095 + 4094, 4095, 1024),
    ("0.5", 0, 2048, 1024),  # empty
    ("0.5", 1, 2048, 1024),
    ("single", 5000, 4096, 1024),
    ("single", 700, 4096, 128),
    ("0.5", 4096, 2048, 128),
    ("0.3", 4096, 2048, 4096),
]


@pytest.mark.parametrize("kind,n,block_bytes,seg_bits", CASES)
def test_container_bytes_match_jax(kind, n, block_bytes, seg_bits):
    data = _data(kind, n)
    jc = JCodec.fit(data, seg_bits=seg_bits, block_bytes=block_bytes)
    jblob = jwrite(jc.encode(data))
    pc = GapArrayCodec.fit(data, seg_bits=seg_bits, block_bytes=block_bytes,
                           device="cpu")
    comp = pc.encode(data)
    blob = write_container(comp)
    assert blob == jblob
    assert comp.compressed_bytes == len(blob)
    # each package decodes what the other wrote
    out = pc.decode(read_container(jblob))
    assert out.dtype == torch.uint8 and np.array_equal(out.numpy(), data)
    assert np.array_equal(jc.decode(jread(blob)), data)
    assert container_kind(blob) == jkind(jblob) == "htc1"


def test_encode_in_groups_matches_jax(monkeypatch):
    # more full blocks than one device group holds: encode and decode run
    # group by group, and the bytes are those of one group
    from huffman_tpu_torch.models import gap_codec

    data = _data("0.6", 5 * 1024 + 300, seed=12)
    pc = GapArrayCodec.fit(data, block_bytes=1024, device="cpu")
    whole = write_container(pc.encode(data))
    monkeypatch.setattr(gap_codec, "GROUP_BYTES", 2 * 1024)
    sizes = []
    encode_device = GapArrayCodec.encode_device
    monkeypatch.setattr(
        GapArrayCodec, "encode_device",
        lambda self, b: sizes.append(b.shape) or encode_device(self, b))
    blob = write_container(pc.encode(data))
    assert sizes == [(2, 1024), (2, 1024), (1, 1024), (300,)]
    assert blob == whole
    jc = JCodec.fit(data, block_bytes=1024)
    assert blob == jwrite(jc.encode(data))
    assert np.array_equal(pc.decode(read_container(blob)).numpy(), data)


def test_decode_jax_compressed_through_convert():
    data = _data("0.6", 3 * 4096 + 300)
    jc = JCodec.fit(data, block_bytes=4096)
    comp = _to_port(jc.encode(data))
    pc = GapArrayCodec(comp.table, seg_bits=comp.seg_bits,
                       block_bytes=comp.block_bytes, device="cpu")
    assert np.array_equal(pc.decode(comp).numpy(), data)
    assert write_container(comp) == jwrite(jc.encode(data))


def test_read_container_errors_match_jax():
    data = _data("0.5", 3000)
    blob = write_container(
        GapArrayCodec.fit(data, block_bytes=1024, device="cpu").encode(data))
    bad_payload = bytearray(blob)
    bad_payload[-3] ^= 0x10
    v3 = bytearray(blob)
    v3[4] = 3
    cases = {
        "bad magic": b"XXXX" + blob[4:],
        "short": blob[:5],
        "version": bytes(v3),
        "truncated": blob[:-7],
        "trailing": blob + b"\0",
        "checksum": bytes(bad_payload),
    }
    for label, buf in cases.items():
        with pytest.raises(ValueError) as jerr:
            jread(buf)
        with pytest.raises(ValueError) as perr:
            read_container(buf)
        assert str(perr.value) == str(jerr.value), label
    for buf in (b"ILS1", b"HTC1", b"junk"):
        try:
            expect = jkind(buf)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                container_kind(buf)
        else:
            assert container_kind(buf) == expect


def test_version1_container_reads_the_same():
    data = _data("0.4", 2500)
    blob = jwrite(JCodec.fit(data, block_bytes=1024).encode(data))
    # v1: no crc field
    v1 = blob[:4] + b"\x01" + blob[5:10] + blob[14:]
    jcomp, comp = jread(v1), read_container(v1)
    assert write_container(comp) == jwrite(jcomp) == blob
    pc = GapArrayCodec(comp.table, block_bytes=1024, device="cpu")
    assert np.array_equal(pc.decode(comp).numpy(), data)


def test_codec_arguments_match_jax():
    table = GapArrayCodec.fit(_data("0.5", 100), device="cpu").table
    for kw in ({"block_bytes": (1 << 27) + 1}, {"seg_bits": 1000}):
        with pytest.raises(ValueError) as jerr:
            JCodec(table, **kw)
        with pytest.raises(ValueError) as perr:
            GapArrayCodec(table, device="cpu", **kw)
        assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kind,g,b,seg_bits", [
    ("0.5", 3, 2048, 1024),
    # not a multiple of 128 (the JAX package's encode_block route)
    ("0.9", 2, 1000, 128),
    ("single", 1, 2048, 128),
    ("0.5", 3, 777, 1024),
])
def test_device_resident_matches_jax(kind, g, b, seg_bits):
    data = _data(kind, g * b)
    jc = JCodec.fit(data, seg_bits=seg_bits, block_bytes=b)
    pc = GapArrayCodec.fit(data, seg_bits=seg_bits, block_bytes=b,
                           device="cpu")
    blocks = data.reshape(g, b)
    jd = jc.encode_device(blocks)
    pd = pc.encode_device(torch.from_numpy(blocks.copy()))
    for name in ("words", "total_bits", "gaps", "counts"):
        a = getattr(pd, name).numpy()
        if name == "words":
            a = a.view(np.uint32)
        assert np.array_equal(a, np.asarray(getattr(jd, name))), name
    assert (pd.original_size, pd.block_bytes) == (g * b, b)
    assert np.array_equal(pc.decode_device(pd).numpy(), blocks)
    # a JAX device group decodes here
    jt = jd.table
    carried = device_compressed_from_numpy(
        jt.lengths, jt.max_len, jd.seg_bits, jd.original_size, jd.block_bytes,
        np.asarray(jd.words), np.asarray(jd.total_bits), np.asarray(jd.gaps),
        np.asarray(jd.counts), device="cpu")
    assert np.array_equal(pc.decode_device(carried).numpy(), blocks)
    # staged to the host, the group writes the container encode writes
    comp = Compressed(table=pc.table, seg_bits=seg_bits, original_size=g * b,
                      block_bytes=b, block_words=[], block_total_bits=[],
                      block_gaps=[], block_counts=[])
    pc.stage_host(pd, comp)
    assert write_container(comp) == write_container(pc.encode(data))
    # a 1-D input is one block
    one = pc.encode_device(blocks[0])
    assert one.words.shape == (1, pd.words.shape[1])
    assert np.array_equal(one.words.numpy(), pd.words[:1].numpy())


def test_seg_bits_8192_decodes_like_numpy_oracle():
    # ROADMAP trap F3: the JAX Pallas decode is wrong at seg_bits=8192;
    # the port decodes there and agrees with the NumPy oracle
    data = _data("0.5", 3 * 4096, seed=13)
    pc = GapArrayCodec.fit(data, seg_bits=8192, block_bytes=4096,
                           device="cpu")
    dcomp = pc.encode_device(data.reshape(3, 4096))
    assert np.array_equal(pc.decode_device(dcomp).numpy().reshape(-1), data)
    comp = Compressed(table=pc.table, seg_bits=8192, original_size=data.size,
                      block_bytes=4096, block_words=[], block_total_bits=[],
                      block_gaps=[], block_counts=[])
    pc.stage_host(dcomp, comp)
    for i in range(3):
        ref = npref.decode_segments_np(comp.block_words[i], comp.block_gaps[i],
                                       comp.block_counts[i], pc.table, 8192)
        assert np.array_equal(ref, data[4096 * i : 4096 * (i + 1)])
    assert pc.roundtrip_check(data)


def test_large_counts_decode_on_the_device_path():
    # 4096 one-bit codewords fill a seg_bits=4096 segment: the device form
    # holds the count (the container's 12-bit field would not)
    data = np.full(3 * 4096, 5, np.uint8)
    pc = GapArrayCodec.fit(data, seg_bits=4096, block_bytes=4096,
                           device="cpu")
    dcomp = pc.encode_device(data.reshape(3, 4096))
    assert int(dcomp.counts.max()) == 4096
    assert np.array_equal(pc.decode_device(dcomp).numpy().reshape(-1), data)


def test_codec_paths_run_the_encode_kernels_not_encode_block(monkeypatch):
    # GapArrayCodec.encode (ragged tail), encode_device (odd block size)
    # and the sharded encode go through encode_blocks' B4b-B4d; the
    # second encoder, ops/encode.py::encode_block, is never called
    import huffman_tpu_torch.ops as tops
    from huffman_tpu_torch import parallel as par
    from huffman_tpu_torch.models import gap_codec
    from huffman_tpu_torch.ops import encode as tenc
    from huffman_tpu_torch.ops import gap_encode_kernels as ge
    from huffman_tpu_torch.parallel import codec as pcodec

    def refuse(*a, **k):
        raise AssertionError("encode_block called on a codec path")

    monkeypatch.setattr(tenc, "encode_block", refuse)
    monkeypatch.setattr(tops, "encode_block", refuse)
    assert not hasattr(gap_codec, "encode_block")
    assert not hasattr(pcodec, "encode_block")
    calls = []
    for name in ("gap_row_pack", "gap_row_meta", "gap_place_bits"):
        fn = getattr(ge, name)
        monkeypatch.setattr(ge, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))

    data = _data("0.5", 2 * 1000 + 7)
    pc = GapArrayCodec.fit(data, block_bytes=1000, device="cpu")
    blob = write_container(pc.encode(data))
    jc = JCodec.fit(data, block_bytes=1000)
    assert blob == jwrite(jc.encode(data))
    # one group of two blocks, then the tail
    assert calls == ["gap_row_pack", "gap_row_meta", "gap_place_bits"] * 2
    calls.clear()
    blocks = data[:2000].reshape(2, 1000)
    pd = pc.encode_device(torch.from_numpy(blocks.copy()))
    assert np.array_equal(pc.decode_device(pd).numpy(), blocks)
    assert len(calls) == 3
    calls.clear()
    mesh = par.data_mesh(device="cpu")
    try:
        words, total_bits, gaps, counts = par.make_sharded_encode(
            mesh, seg_bits=pc.seg_bits, max_words=pd.words.shape[1] - 1,
            n_segs=pd.counts.shape[1])(torch.from_numpy(blocks.copy()), pc.enc)
    finally:
        mesh.close()
    assert len(calls) == 3
    for a, b in ((words, pd.words), (total_bits, pd.total_bits),
                 (gaps, pd.gaps), (counts, pd.counts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("block_bytes", [1024, 1000])
def test_f13_segments_shorter_than_codes_round_trip(block_bytes):
    # seg_bits 8 under 16-bit codes: a segment can lie inside one codeword.
    # encode_block points its gap at the next start; the JAX package's
    # Pallas route (blocks of a multiple of 128 bytes) points it at
    # total_bits, which the container's 4-bit gap field cannot hold
    # (ROADMAP F13).  The port writes encode_block's gaps for every block:
    # its bytes equal the JAX package's where the JAX package takes
    # encode_block (1000-byte blocks), and both packages decode them
    import jax
    import jax.numpy as jnp

    import huffman_tpu.io.yamamoto as jyam
    from huffman_tpu.ops import device_enc_table as jdevice_enc_table
    from huffman_tpu.ops.encode import encode_block as jencode_block

    from huffman_tpu_torch.io import table_from_length_sequence

    syms = np.r_[np.arange(40, 55), 56, 55].astype(np.uint8)
    lens = np.r_[np.arange(1, 16), 16, 16]
    rng = np.random.default_rng(0)
    data = syms[rng.choice(17, size=2 * block_bytes + 300,
                           p=np.r_[[0.01] * 15, 0.4, 0.45])]
    jt = jyam.table_from_length_sequence(syms, lens)
    kw = dict(seg_bits=8, block_bytes=block_bytes)
    jc = JCodec(jt, **kw)
    pc = GapArrayCodec(table_from_length_sequence(syms, lens), device="cpu",
                       **kw)
    blob = write_container(pc.encode(data))
    assert np.array_equal(pc.decode(read_container(blob)).numpy(), data)
    assert np.array_equal(jc.decode(jread(blob)), data)
    if block_bytes % 128:
        assert blob == jwrite(jc.encode(data))
        return
    # the JAX Pallas route takes about a minute in interpret mode here:
    # the blocks are held to the JAX encode_block instead
    blocks = data[: 2 * block_bytes].reshape(2, block_bytes)
    pd = pc.encode_device(torch.from_numpy(blocks.copy()))
    max_words, n_segs = pd.words.shape[1] - 1, pd.gaps.shape[1]
    ref = jax.vmap(lambda d: jencode_block(
        d, jdevice_enc_table(jt), seg_bits=8, max_words=max_words,
        n_segs=n_segs))(jnp.asarray(blocks))
    for name, r in zip(("words", "total_bits", "gaps", "counts"), ref):
        a = getattr(pd, name).numpy()
        assert np.array_equal(a.view(np.uint32) if name == "words" else a,
                              np.asarray(r)), name


@pytest.mark.parametrize("seg_bits", [4096, 8192])
def test_f16_counts_over_the_container_field_are_refused(seg_bits):
    # two symbols, 1-bit codes: a segment of seg_bits bits holds seg_bits
    # codewords, over the container's 12-bit count (ROADMAP F16).  The JAX
    # package writes the wrapped counts and its container decodes wrong;
    # the port refuses to write it, and the blocks round-trip in memory
    data = np.random.default_rng(0).choice(
        np.array([8, 75], np.uint8), 2 * seg_bits + 9, p=[0.01, 0.99])
    kw = dict(max_len=16, seg_bits=seg_bits, block_bytes=1 << 24)
    jc = JCodec.fit(data, method="lut", **kw)
    jcomp = jc.encode(data)
    assert not np.array_equal(np.asarray(jc.decode(jread(jwrite(jcomp)))),
                              data)
    pc = GapArrayCodec.fit(data, device="cpu", **kw)
    comp = pc.encode(data)
    assert max(int(c.max()) for c in comp.block_counts) >= 4096
    with pytest.raises(ValueError, match="12-bit count"):
        write_container(comp)
    assert np.array_equal(pc.decode(comp).numpy(), data)
    # a seg_bits whose counts fit: both packages' bytes, and both decode
    kw["seg_bits"] = 2048
    blob = write_container(GapArrayCodec.fit(data, device="cpu", **kw)
                           .encode(data))
    assert blob == jwrite(JCodec.fit(data, method="lut", **kw).encode(data))
    assert np.array_equal(pc.decode(read_container(blob)).numpy(), data)


def test_decodes_zero_fill_only_where_counts_are_not_shown_in_range():
    # both plans read the counts' least value: a valid group's output is
    # never zero-filled before B1 places its bytes; a hand-made container
    # with a negative count (in the tail's last segment, which nothing
    # follows) is: its other segments' bytes are placed, the rest is zero
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.utils import trace

    data = _data("0.5", 3 * 2048 + 777)
    pc = GapArrayCodec.fit(data, block_bytes=2048, device="cpu")
    comp = pc.encode(data)
    plan = pc.decode_plan(comp, [0, 1, 2])
    assert plan[4] is True
    dplan = pc.decode_device_plan(pc.encode_device(data[:4096].reshape(2, 2048)))
    assert dplan[4] is True and len(dplan) == 5
    trace.drain()
    assert np.array_equal(pc.decode(comp).numpy(), data)
    assert gd.ZERO_FILLS not in trace.drain()["counters"]
    comp.block_counts[-1] = comp.block_counts[-1].copy()
    comp.block_counts[-1][-1] = -4
    assert pc.decode_plan(comp, [3])[4] is False
    got = pc.decode(comp).numpy()
    assert trace.drain()["counters"][gd.ZERO_FILLS] == 1
    last = int(np.asarray(comp.block_counts[-1][:-1]).sum())
    assert np.array_equal(got[: 3 * 2048 + last], data[: 3 * 2048 + last])
    assert not got[3 * 2048 + last :].any()
