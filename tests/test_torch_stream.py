"""The ILS file path of the PyTorch port against the JAX package, on the CPU.

The port's `IlsStreamWriter` / `IlsStreamReader` and `IlsCodec.fit_file`,
`encode_file` and `decode_file` run with device="cpu"; the JAX package's
run its Pallas kernels in interpret mode.  Container bytes, tables and
decoded files must be equal (integers, tolerance 0), and the readers must
raise the same errors.  Where the JAX package's halving of a section's k
leaves a k that is not a multiple of 4 (ROADMAP.md F9) its container does
not decode; the port's rounds up, and its container decodes in both.
"""

import io

import numpy as np
import pytest

import huffman_tpu.ops.ils as jils
import huffman_tpu_torch.models.ils_codec as tcodec
import huffman_tpu_torch.ops.ils as tils
from huffman_tpu.io.container import IlsStreamReader as JReader
from huffman_tpu.io.container import IlsStreamWriter as JWriter
from huffman_tpu.io.container import read_ils_container as jread
from huffman_tpu.io.container import write_ils_container as jwrite
from huffman_tpu.models import IlsCodec as JCodec
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch import IlsCodec
from huffman_tpu_torch.core.ils_ref import ILS_LANES
from huffman_tpu_torch.io import (
    code_table_from_numpy,
    read_ils_container,
    section_from_numpy,
    write_ils_container,
)
from huffman_tpu_torch.io.container import IlsStreamReader, IlsStreamWriter
from huffman_tpu_torch.models.ils_codec import IlsCompressed


def _to_port(jcomp):
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


def _jax_sections(rotate):
    # several sections and a tail at the JAX suite's tiny k
    k = 8
    data = generate_redundant(5 * k * ILS_LANES + 100, 0.5, seed=10)
    codec = JCodec.fit(data, k=k, interpret=True, rotate=rotate)
    codec.SECTION_BYTES = 2 * k * ILS_LANES
    return codec.encode(data)


def _stream_write(writer_cls, comp):
    buf = io.BytesIO()
    w = writer_cls(buf, comp.table, comp.original_size)
    for sec in comp.sections:
        w.write_section(sec)
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("rotate", [False, True])
def test_stream_writer_matches_whole_buffer_and_jax(rotate):
    jcomp = _jax_sections(rotate)
    comp = _to_port(jcomp)
    assert len(comp.sections) == 4
    blob = _stream_write(IlsStreamWriter, comp)
    assert blob == write_ils_container(comp)
    assert blob == _stream_write(JWriter, jcomp) == jwrite(jcomp)
    assert blob[4] == (4 if rotate else 3)


def _read_all(reader):
    secs = []
    while (sec := reader.read_section()) is not None:
        secs.append(sec)
    reader.close()
    return secs


def test_stream_reader_matches_whole_buffer():
    blob = jwrite(_jax_sections(True))
    ref = read_ils_container(blob)
    r = IlsStreamReader(io.BytesIO(blob))
    assert r.original_size == ref.original_size
    assert np.array_equal(r.table.lengths, ref.table.lengths)
    secs = _read_all(r)
    assert len(secs) == len(ref.sections)
    for a, b in zip(secs, ref.sections):
        assert a.params.k == b.params.k and a.params.rot == b.params.rot
        assert np.array_equal(a.params.boffs, b.params.boffs)
        assert np.array_equal(a.params.w_tiles, b.params.w_tiles)
        assert np.array_equal(a.payload_u32(), b.payload_u32())


def _stream_error(blob, stage):
    """The message the reader raises at `stage` ("init", "read", "close"),
    in the JAX package and in the port."""
    msgs = []
    for reader_cls in (JReader, IlsStreamReader):
        with pytest.raises(ValueError) as err:
            r = reader_cls(io.BytesIO(blob))
            if stage == "init":
                pytest.fail("the header was accepted")
            if stage == "close":
                r.read_section()
                r.close()
            else:
                while r.read_section() is not None:
                    pass
                pytest.fail("every section was read")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_stream_reader_errors_match_jax():
    jcomp = _jax_sections(False)
    blob = jwrite(jcomp)
    off = 21 + 2 * jcomp.table.num_symbols + 8  # flags word of section 0
    bad = bytearray(blob)
    bad[-5] ^= 0x40  # payload bit flip: the checksum, at close()
    with pytest.raises(ValueError, match="checksum") as ref:
        _read_all(JReader(io.BytesIO(bytes(bad))))
    with pytest.raises(ValueError, match="checksum") as got:
        _read_all(IlsStreamReader(io.BytesIO(bytes(bad))))
    assert str(got.value) == str(ref.value)
    assert "truncated" in _stream_error(blob[:-8], "read")
    assert "truncated" in _stream_error(blob[:30], "read")
    with pytest.raises(ValueError, match="trailing") as got:
        _read_all(IlsStreamReader(io.BytesIO(blob + b"\0")))
    with pytest.raises(ValueError, match="trailing") as ref:
        _read_all(JReader(io.BytesIO(blob + b"\0")))
    assert str(got.value) == str(ref.value)
    assert "before all sections" in _stream_error(blob, "close")
    assert "magic" in _stream_error(b"NOPE" + blob[4:], "init")
    bad = bytearray(blob)
    bad[4] = 5
    assert "version" in _stream_error(bytes(bad), "init")
    for flag in (0x01, 0x02):
        bad = bytearray(blob)
        bad[off] = flag
        assert "flags" in _stream_error(bytes(bad), "read")


# ----------------------------------------------------------------------
# fit_file, encode_file, decode_file
# ----------------------------------------------------------------------
def _file_pair(tmp_path, data, rotate="auto", **enc_kw):
    """(JAX codec, port codec, JAX container bytes, port container bytes,
    source path) of one file."""
    src = tmp_path / "src.bin"
    data.tofile(src)
    jc = JCodec.fit_file(str(src), k=256, rotate=rotate)
    tc = IlsCodec.fit_file(str(src), k=256, rotate=rotate, device="cpu")
    jsize = jc.encode_file(str(src), str(tmp_path / "j.ils"), **enc_kw)
    tsize = tc.encode_file(str(src), str(tmp_path / "t.ils"), **enc_kw)
    jblob = (tmp_path / "j.ils").read_bytes()
    tblob = (tmp_path / "t.ils").read_bytes()
    assert (jsize, tsize) == (len(jblob), len(tblob))
    return jc, tc, jblob, tblob, src


def _decodes(tmp_path, path, data, jax):
    out = tmp_path / "out.bin"
    if jax:
        n = JCodec.decode_file(str(path), str(out))
    else:
        n = IlsCodec.decode_file(str(path), str(out), device="cpu")
    return n == data.size and np.array_equal(np.fromfile(out, np.uint8), data)


@pytest.mark.parametrize("rotate", [False, True])
def test_encode_file_matches_jax(tmp_path, rotate):
    # the JAX suite's multi-section shape (tests/test_stream.py): sections
    # of 2 tiles at k=256 and a ragged tail of one tile at its own k
    data = generate_redundant(1_400_000, 0.5, seed=44)
    jc, tc, jblob, tblob, _ = _file_pair(tmp_path, data, rotate=rotate,
                                         section_bytes=1 << 19)
    assert np.array_equal(tc.table.lengths, jc.table.lengths)
    assert (tc.k, tc.fit_avg_bits) == (jc.k, jc.fit_avg_bits)
    assert tblob == jblob
    assert IlsStreamReader(io.BytesIO(tblob)).n_sections >= 3
    assert tblob[4] == (4 if rotate else 3)
    assert _decodes(tmp_path, tmp_path / "t.ils", data, jax=False)
    comp = read_ils_container(tblob)
    assert np.array_equal(tc.decode(comp).numpy(), data)


def test_fit_file_matches_jax_fit_file(tmp_path):
    data = generate_redundant(300_001, 0.9, seed=45)
    src = tmp_path / "src.bin"
    data.tofile(src)
    for kw in ({}, {"optimize": "ratio"}, {"k": 12}):
        jc = JCodec.fit_file(str(src), chunk_bytes=1 << 16, **kw)
        tc = IlsCodec.fit_file(str(src), chunk_bytes=1 << 16, device="cpu",
                               **kw)
        assert np.array_equal(tc.table.lengths, jc.table.lengths), kw
        assert np.array_equal(tc.table.codes, jc.table.codes), kw
        assert (tc.k, tc.fit_avg_bits) == (jc.k, jc.fit_avg_bits), kw


def _budget(monkeypatch):
    # a row budget of 16 makes the ragged one-tile section halve its k
    for mod in (jils, tils):
        monkeypatch.setattr(mod, "VMEM_ROW_BUDGET", 16)
        monkeypatch.setattr(mod, "MIN_K", 8)


def _attempts(monkeypatch):
    ks = []
    real = tcodec.ils_encode_device

    def record(buf, *a, k, **kw):
        ks.append((k, buf.numel()))
        return real(buf, *a, k=k, **kw)

    monkeypatch.setattr(tcodec, "ils_encode_device", record)
    return ks


def test_f9_port_rounds_up_where_jax_writes_a_short_container(
        tmp_path, monkeypatch):
    # k_sec = 4 * 51 for the one-tile chunk: the JAX package halves it to
    # 102 and 51 and writes 4 tiles of k=51, which decode 12188 bytes
    # short; the port takes 104 and 52, its chunk zero-padded to 4 tiles
    _budget(monkeypatch)
    ks = _attempts(monkeypatch)
    data = generate_redundant(4096 * 51 - 100, 0.5, seed=3)
    _, _, jblob, tblob, _ = _file_pair(tmp_path, data, section_bytes=1 << 20)
    assert ks == [(204, 204 * 1024), (104, 208 * 1024), (52, 208 * 1024)]
    jks = [s.params.k for s in jread(jblob).sections]
    tks = [s.params.k for s in read_ils_container(tblob).sections]
    assert any(k % 4 for k in jks) and not any(k % 4 for k in tks)
    assert tks == [52]
    with pytest.raises(ValueError, match="12188 bytes short"):
        JCodec.decode_file(str(tmp_path / "j.ils"), str(tmp_path / "o.bin"))
    with pytest.raises(ValueError):
        IlsCodec.decode_file(str(tmp_path / "j.ils"), str(tmp_path / "o.bin"),
                             device="cpu")
    t_path = tmp_path / "t.ils"
    assert _decodes(tmp_path, t_path, data, jax=False)
    assert _decodes(tmp_path, t_path, data, jax=True)
    assert np.array_equal(IlsCodec(read_ils_container(tblob).table,
                                   device="cpu").decode(
        read_ils_container(tblob)).numpy(), data)
    jcomp = jread(tblob)
    assert np.array_equal(JCodec(jcomp.table, interpret=True).decode(jcomp),
                          data)


def test_f9_free_halving_matches_jax(tmp_path, monkeypatch):
    # k_sec = 4 * 52 halves to 104 and 52, multiples of 4: the same
    # sequence and the same bytes in both packages
    _budget(monkeypatch)
    ks = _attempts(monkeypatch)
    data = generate_redundant(4096 * 52 - 100, 0.5, seed=3)
    _, _, jblob, tblob, _ = _file_pair(tmp_path, data, section_bytes=1 << 20)
    assert [k for k, _ in ks] == [208, 104, 52]
    assert tblob == jblob
    assert _decodes(tmp_path, tmp_path / "t.ils", data, jax=False)


def test_encode_file_counts_the_histogram_once_per_chunk(tmp_path,
                                                          monkeypatch):
    # the retries reuse the chunk's counts, the padding added to byte 0:
    # the same avg_bits as counting each padded chunk anew
    _budget(monkeypatch)
    data = generate_redundant(4096 * 51 - 100, 0.5, seed=3)
    src = tmp_path / "src.bin"
    data.tofile(src)
    tc = IlsCodec.fit_file(str(src), k=256, device="cpu")
    counted, avgs = [], []
    real_hist = tcodec.npref.histogram
    real_enc = tcodec.ils_encode_device
    monkeypatch.setattr(tcodec.npref, "histogram",
                        lambda d: counted.append(1) or real_hist(d))

    def record(buf, *a, avg_bits, **kw):
        avgs.append((avg_bits, tc._avg_bits(buf)))
        return real_enc(buf, *a, avg_bits=avg_bits, **kw)

    monkeypatch.setattr(tcodec, "ils_encode_device", record)
    tc.encode_file(str(src), str(tmp_path / "t.ils"), section_bytes=1 << 20)
    assert len(avgs) == 3
    assert len(counted) == 1 + len(avgs)  # the chunk once; the checks here
    assert all(a == b for a, b in avgs)


def test_f9_whole_tile_sections_before_the_last_stay_unpadded(
        tmp_path, monkeypatch):
    # a chosen k = 4 * 51 on sections of one whole tile: a section before
    # the file's last may not be zero-padded (the zeros would land inside
    # the file), so its retries take the multiples of 4 under half of k
    # that divide its 204 * 1024 bytes; only the last section is padded
    _budget(monkeypatch)
    ks = _attempts(monkeypatch)
    data = generate_redundant(2 * 204 * 1024 + 5, 0.5, seed=3)
    src = tmp_path / "src.bin"
    data.tofile(src)
    tc = IlsCodec.fit_file(str(src), k=204, device="cpu")
    t_path = tmp_path / "t.ils"
    tc.encode_file(str(src), str(t_path), section_bytes=204 * 1024)
    whole = [(204, 204 * 1024), (68, 204 * 1024)]
    assert ks == whole + whole + [(8, 8 * 1024)]
    comp = read_ils_container(t_path.read_bytes())
    assert [(s.params.k, s.params.n_tiles) for s in comp.sections] == [
        (68, 3), (68, 3), (8, 1)]
    assert _decodes(tmp_path, t_path, data, jax=False)
    assert _decodes(tmp_path, t_path, data, jax=True)
    assert np.array_equal(tc.decode(comp).numpy(), data)
    jcomp = jread(t_path.read_bytes())
    assert np.array_equal(JCodec(jcomp.table, interpret=True).decode(jcomp),
                          data)
