"""The port's native host module and reference-binary bridge.

`huffman_tpu_torch.native` is built by g++ from `csrc/host_native.cpp`
into `build/` at first use.  Each function must give what the port's NumPy
path gives and what the JAX package's native module gives (where that one
is built), on the cases of `tests/test_native.py`.  `io/refbin.py` drives
the reference's `sequential.cpp`, which skips where that source is absent,
as `tests/test_refbin.py` does; its driver's build is checked on a stand-in
source.
"""

import os
import textwrap
from pathlib import Path

import numpy as np
import pytest

from huffman_tpu import native as jnative
from huffman_tpu_torch import native
from huffman_tpu_torch.core import canonical_code_table, npref
from huffman_tpu_torch.core.package_merge import package_merge_lengths
from huffman_tpu_torch.io import refbin
from huffman_tpu_torch.io.seqfmt import (
    PrefixCode,
    decode_seq,
    host_lut_decode,
    write_seq,
)
from huffman_tpu_torch.utils import generate_redundant

REPO = Path(__file__).resolve().parents[1]

needs_native = pytest.mark.skipif(
    not native.available(), reason="no C++ compiler for the native module"
)


def _jax_native():
    return jnative if jnative.available() else None


@needs_native
@pytest.mark.parametrize("r", [0.0, 0.5, 1.0])
def test_histogram_matches(r):
    data = generate_redundant(1_000_001, r, seed=20)
    got = native.histogram(data)
    assert got.dtype == np.int64
    assert np.array_equal(got, np.bincount(data, minlength=256))
    assert np.array_equal(npref.histogram(data), got)
    if _jax_native():
        assert np.array_equal(jnative.histogram(data), got)


@needs_native
@pytest.mark.parametrize("r", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("max_len", [8, 12, 16])
def test_package_merge_matches(r, max_len):
    data = generate_redundant(300_000, r, seed=21)
    freqs = npref.histogram(data)
    assert int(np.count_nonzero(freqs)) <= (1 << max_len)
    got = native.package_merge_lengths(freqs, max_len)
    assert np.array_equal(got, package_merge_lengths(freqs, max_len))
    if _jax_native():
        assert np.array_equal(jnative.package_merge_lengths(freqs, max_len), got)


@needs_native
def test_package_merge_edge_cases():
    freqs = np.zeros(256, np.int64)
    assert np.array_equal(native.package_merge_lengths(freqs, 16),
                          np.zeros(256, np.uint8))
    freqs[7] = 100
    lens = native.package_merge_lengths(freqs, 16)
    assert lens[7] == 1 and lens.sum() == 1
    freqs[:] = 1  # uniform 256 symbols -> exactly 8 bits each
    assert np.all(native.package_merge_lengths(freqs, 16) == 8)
    with pytest.raises(ValueError, match="rc=-2"):
        native.package_merge_lengths(freqs, 7)  # 256 symbols in 7 bits
    freqs[3] = -1
    with pytest.raises(ValueError, match="rc=-1"):
        native.package_merge_lengths(freqs, 16)


@needs_native
def test_canonical_matches():
    data = generate_redundant(200_000, 0.4, seed=22)
    lengths = package_merge_lengths(npref.histogram(data), 16)
    table = canonical_code_table(lengths, 16)
    codes, symtab = native.canonical_pieces(lengths)
    assert np.array_equal(codes, table.codes)
    assert np.array_equal(symtab, table.symtab)
    if _jax_native():
        jcodes, jsymtab = jnative.canonical_pieces(lengths)
        assert np.array_equal(jcodes, codes) and np.array_equal(jsymtab, symtab)


@needs_native
def test_canonical_rejects_kraft_violation():
    lengths = np.zeros(256, np.uint8)
    lengths[:3] = 1  # three 1-bit codes: impossible
    with pytest.raises(ValueError, match="Kraft"):
        native.canonical_pieces(lengths)


@needs_native
@pytest.mark.parametrize("n", [0, 1, 100_000])
def test_encode_bits_matches(n, monkeypatch):
    base = generate_redundant(100_000, 0.5, seed=23)
    table = canonical_code_table(
        package_merge_lengths(npref.histogram(base), 16), 16)
    data = base[:n]
    w_nat, t_nat = native.encode_bits(data, table.codes, table.lengths)
    assert npref.encode_bits(data, table)[1] == t_nat  # the native route
    if _jax_native():
        w_j, t_j = jnative.encode_bits(data, table.codes, table.lengths)
        assert t_j == t_nat and np.array_equal(w_j, w_nat)
    monkeypatch.setattr(native, "available", lambda: False)
    w_np, t_np = npref.encode_bits(data, table)
    assert t_nat == t_np
    if n == 0:
        assert t_nat == 0
        return
    assert np.array_equal(w_nat, w_np)


@needs_native
def test_encode_bits_rejects_an_absent_symbol(monkeypatch):
    table = canonical_code_table(
        package_merge_lengths(np.r_[5, 3, np.zeros(254, np.int64)], 16), 16)
    data = np.array([0, 1, 2], np.uint8)
    with pytest.raises(ValueError) as got:
        npref.encode_bits(data, table)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError) as ref:
        npref.encode_bits(data, table)
    assert str(got.value) == str(ref.value)


def _greedy_code(data):
    """A non-canonical prefix code: the greedy tree's lengths, codewords
    assigned in reverse symbol order, the tree mirrored at its root (each
    codeword's first bit flipped)."""
    from huffman_tpu_torch.core import huffman_lengths_unbounded

    lengths = huffman_lengths_unbounded(npref.histogram(data))
    syms = np.nonzero(lengths)[0]
    order = sorted(syms, key=lambda s: (lengths[s], -s))
    codes = np.zeros(256, np.uint32)
    code, prev = 0, int(lengths[order[0]])
    for i, s in enumerate(order):
        if i:
            code = (code + 1) << (int(lengths[s]) - prev)
        prev = int(lengths[s])
        codes[s] = code ^ (1 << (prev - 1))
    return PrefixCode(lengths=lengths.astype(np.uint8), codes=codes)


def _pack(data, code):
    bits = "".join(format(int(code.codes[b]), f"0{code.lengths[b]}b")
                   for b in data)
    payload = np.packbits(np.frombuffer(bits.encode(), np.uint8) - 48)
    return payload, len(bits)


@needs_native
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_prefix_lut_matches_the_numpy_walk(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    data = np.minimum(rng.geometric(0.15, size=4000) - 1, 255).astype(np.uint8)
    code = _greedy_code(data)
    payload, total_bits = _pack(data, code)
    lut_sym, lut_len = code.flat_lut()
    got = native.decode_prefix_lut(payload, total_bits, lut_sym, lut_len,
                                   code.max_len, out_cap=data.size + 1)
    assert np.array_equal(got, data)
    assert np.array_equal(host_lut_decode(payload, total_bits, code), data)
    if _jax_native():
        assert np.array_equal(jnative.decode_prefix_lut(
            payload, total_bits, lut_sym, lut_len, code.max_len,
            out_cap=data.size + 1), data)
    monkeypatch.setattr(native, "available", lambda: False)
    assert np.array_equal(host_lut_decode(payload, total_bits, code), data)
    with pytest.raises(ValueError, match="rc=-2"):
        native.decode_prefix_lut(payload, total_bits, lut_sym, lut_len,
                                 code.max_len, out_cap=data.size - 1)


@needs_native
def test_foreign_seq_blob_takes_the_native_walk(monkeypatch):
    # a sequential-format blob with a non-canonical code: decode_seq routes
    # it to the host walk, now in C, as the JAX package does
    from huffman_tpu.io.seqfmt import decode_seq as jdecode_seq

    data = generate_redundant(20_000, 0.5, seed=24)
    code = _greedy_code(data)
    payload, total_bits = _pack(data, code)
    syms = np.nonzero(code.lengths)[0]
    parts = [bytes([payload.size * 8 - total_bits]),
             len(syms).to_bytes(2, "big")]
    parts += [bytes([s, code.lengths[s]])
              + format(int(code.codes[s]), f"0{code.lengths[s]}b").encode()
              for s in syms]
    blob = b"".join(parts) + payload.tobytes()
    calls = []
    real = native.decode_prefix_lut
    monkeypatch.setattr(native, "decode_prefix_lut",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = decode_seq(blob, device="cpu").numpy()
    assert calls and np.array_equal(got, data)
    assert np.array_equal(np.asarray(jdecode_seq(blob, device=False)), data)


def test_builds_under_build_never_in_native(tmp_path, monkeypatch):
    # a fresh build lands under the port's build root; the JAX package's
    # native/ directory neither gains nor serves a file
    if not native._compilers():
        pytest.skip("no C++ compiler")
    before = sorted(p.name for p in (REPO / "native").iterdir())
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available()
    path = native.library_path()
    assert path.is_file() and tmp_path / "build" in path.parents
    assert path.name == "libhost_native.so"
    assert sorted(p.name for p in (REPO / "native").iterdir()) == before
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    data = generate_redundant(70_000, 0.5, seed=25)
    assert np.array_equal(native.histogram(data), np.bincount(data, minlength=256))
    src = (REPO / "huffman_tpu_torch" / "native.py").read_text()
    for name in ("libhuffman_native", "HUFFMAN_TPU_NATIVE",
                 "HUFFMAN_TPU_NO_NATIVE", '"native"'):
        assert name not in src, name


def test_a_compiler_without_openmp_gives_way_to_the_next(tmp_path,
                                                         monkeypatch):
    # a $CXX that cannot link OpenMP (no libgomp) must not leave the module
    # unbuilt where g++ on the PATH builds it
    if not native._compilers():
        pytest.skip("no C++ compiler")
    bad = tmp_path / "cxx-without-gomp"
    bad.write_text("#!/bin/sh\necho \"cannot read spec file 'libgomp.spec'\" >&2\n"
                   "exit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native._compilers()[0] == str(bad)
    assert native.available() and native.unavailable_reason() is None
    # with no compiler that works, every message is kept
    monkeypatch.setattr(native, "_compilers", lambda: [str(bad)])
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build2")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    assert "libgomp.spec" in native.unavailable_reason()


def test_without_a_compiler_the_host_paths_run_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_compilers", lambda: [])
    assert not native.available()
    assert not (tmp_path / "build").exists()
    assert native.unavailable_reason().startswith("OSError: no C++ compiler")
    with pytest.raises(RuntimeError, match="not available: OSError"):
        native.histogram(np.zeros(4, np.uint8))
    data = generate_redundant(70_000, 0.5, seed=26)
    assert np.array_equal(npref.histogram(data), np.bincount(data, minlength=256))
    table = canonical_code_table(
        package_merge_lengths(npref.histogram(data), 16), 16)
    blob = write_seq(data, table)
    assert np.array_equal(decode_seq(blob, selfsync=False, device="cpu")
                          .numpy(), data)


# ----------------------------------------------------------------------
# The reference-binary bridge
# ----------------------------------------------------------------------
needs_ref = pytest.mark.skipif(
    not refbin.ref_available(),
    reason="reference sequential.cpp not present on this host",
)


def _fit(data, max_len=16):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), max_len), max_len)


@needs_ref
@pytest.mark.parametrize("r", [0.1, 0.5, 0.9])
def test_refbin_interop_small(r):
    data = generate_redundant(200_000, r, seed=int(r * 10))
    blob = refbin.ref_encode(data)
    assert isinstance(blob, bytes)
    assert np.array_equal(decode_seq(blob, selfsync=False, device="cpu")
                          .numpy(), data)
    out = refbin.ref_decode(write_seq(data, _fit(data)))
    assert out.dtype == np.uint8 and np.array_equal(out, data)


@needs_ref
def test_refbin_tiny_and_single_symbol():
    one = np.full(1000, 7, np.uint8)
    assert np.array_equal(
        decode_seq(refbin.ref_encode(one), selfsync=False, device="cpu")
        .numpy(), one)
    assert np.array_equal(refbin.ref_decode(write_seq(one, _fit(one))), one)


_STAND_IN = textwrap.dedent("""\
    // a stand-in for the reference: encode reverses, decode reverses back
    #include <cstdint>
    #include <vector>
    struct HuffmanSequential {
        std::vector<uint8_t> encode(const std::vector<uint8_t>& in) {
            return std::vector<uint8_t>(in.rbegin(), in.rend());
        }
        std::vector<uint8_t> decode(const std::vector<uint8_t>& in) {
            return std::vector<uint8_t>(in.rbegin(), in.rend());
        }
    };
    int main() { return 1; }
""")


def test_refbin_driver_builds_under_build(tmp_path, monkeypatch):
    # the driver's build and file protocol, on a stand-in source
    if not native._compilers():
        pytest.skip("no C++ compiler")
    src = tmp_path / "sequential.cpp"
    src.write_text(_STAND_IN)
    monkeypatch.setenv("HUFFMAN_TPU_REF_SEQ", str(src))
    monkeypatch.setattr(refbin, "BUILD_ROOT", tmp_path / "build")
    assert refbin.ref_seq_source() == src and refbin.ref_available()
    exe = refbin.build_ref_driver()
    assert exe.is_file() and tmp_path / "build" in exe.parents
    assert refbin.build_ref_driver() == exe  # cached by the digest
    data = np.arange(300, dtype=np.uint8)
    blob = refbin.ref_encode(data)
    assert blob == data[::-1].tobytes()
    out = refbin.ref_decode(blob)
    assert out.dtype == np.uint8 and np.array_equal(out, data)
    monkeypatch.delenv("HUFFMAN_TPU_REF_SEQ")
    assert refbin.ref_seq_source() == REPO / "reference" / "sequential.cpp"
    assert os.path.dirname(refbin.DRIVER_SRC) == str(
        REPO / "huffman_tpu_torch" / "csrc")
