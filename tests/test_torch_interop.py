"""Foreign-stream decode of the port against the JAX package, on the CPU.

The Yamamoto container (writer, reader, table rebuild, decode through the
count kernel C1 and B1 + B2), the sequential.cpp blob (writer, header,
host walk, self-sync decode) and the self-sync pieces (the transition
kernel C2's plain version, the composition scan, the whole decoder) are
held to `huffman_tpu/io/yamamoto.py`, `io/seqfmt.py`, `models/selfsync.py`
and the Pallas kernels `count_segments_pallas` and `sync_transitions` in
interpret mode (inputs of at most 20 KB there).  Inputs come from NumPy
with a seed; every value is an integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.core import canonical_code_table as jcct
from huffman_tpu.core import npref as jnpref
from huffman_tpu.core import package_merge_lengths as jpml
from huffman_tpu.io import seqfmt as jseq
from huffman_tpu.io import yamamoto as jyam
from huffman_tpu.models import selfsync as jss
from huffman_tpu.ops import dec_spec as jdec_spec
from huffman_tpu.ops import device_dec_table as jdevice_dec_table
from huffman_tpu.ops.decode import count_segments as jcount_segments
from huffman_tpu.ops.pallas.decode_kernel import count_segments_pallas
from huffman_tpu.ops.pallas.selfsync_kernels import sync_transitions as jsync
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch import GapArrayCodec
from huffman_tpu_torch.core.canonical import canonical_code_table
from huffman_tpu_torch.io import seqfmt, yamamoto
from huffman_tpu_torch.models import selfsync
from huffman_tpu_torch.ops import gap_decode_kernels as gd
from huffman_tpu_torch.ops import selfsync_kernels as sk
from huffman_tpu_torch.ops import tables as tt

KINDS = ["0", "0.5", "0.9", "single"]


def _input(kind, n, seed=1):
    if kind == "single":
        return np.full(n, 7, np.uint8)
    if kind == "uniform":
        return np.arange(n, dtype=np.uint8)
    if kind == "three":  # lengths 1, 2, 2: walks that meet, few levels
        return np.random.default_rng(seed).choice(
            np.array([5, 6, 7], np.uint8), n, p=[0.5, 0.25, 0.25])
    if kind == "skew16":
        # every length 1..16 present: symbol i drawn with weight 2**-i
        rng = np.random.default_rng(seed)
        p = 2.0 ** -np.arange(1, 18)
        return rng.choice(17, size=n, p=p / p.sum()).astype(np.uint8) + 40
    return generate_redundant(n, float(kind), seed=seed)


def _jtable(data):
    return jcct(jpml(jnpref.histogram(data), 16), 16)


def _ptable(jt):
    return canonical_code_table(jt.lengths, 16)


def _skew16_table():
    """A max_len=16 table whose two 16-bit codes tie in the file against
    symbol order (lengths 1..15, then 16 twice)."""
    lens = np.r_[np.arange(1, 16), 16, 16].astype(np.int64)
    return np.r_[np.arange(40, 55), 56, 55].astype(np.uint8), lens


def _tables(kind, data):
    if kind == "skew16":
        syms, lens = _skew16_table()
        return (jyam.table_from_length_sequence(syms, lens),
                yamamoto.table_from_length_sequence(syms, lens))
    jt = _jtable(data)
    return jt, _ptable(jt)


def _same_table(a, b):
    for f in ("lengths", "codes", "symtab", "counts", "first_code", "offsets",
              "lim_left"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.max_len == b.max_len


def _encoded(kind, n, seed=1):
    data = _input(kind, n, seed)
    jt, pt = _tables(kind, data)
    words, total_bits = jnpref.encode_bits(data, jt)
    return data, jt, pt, words[:-1], total_bits


def _lim(pt):
    return gd.kernel_tabs(tt.device_dec_table(pt, device="cpu"))[0]


def _t32(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.uint32)
                            .view(np.int32))


# ----------------------------------------------------------------------
# Writers, readers, tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1, 1000, 20_000])
def test_writers_match_jax(kind, n):
    data = _input(kind, n)
    jt = _jtable(data)
    assert yamamoto.write_yamamoto(data, jt) == jyam.write_yamamoto(data, jt)
    assert seqfmt.write_seq(data, jt) == jseq.write_seq(data, jt)


@pytest.mark.parametrize("kind", KINDS + ["uniform", "skew16"])
def test_readers_match_jax(kind):
    data = _input(kind, 5000)
    jt, _ = _tables(kind, data)
    blob = jyam.write_yamamoto(data, jt)
    jtab, jwords, jgaps, jsize = jyam.read_yamamoto(blob)
    ptab, pwords, pgaps, psize = yamamoto.read_yamamoto(blob)
    _same_table(ptab, jtab)
    assert np.array_equal(pwords, jwords) and pwords.dtype == np.uint32
    assert np.array_equal(pgaps, jgaps) and pgaps.dtype == np.uint8
    assert psize == jsize == data.size
    blob = jseq.write_seq(data, jt)
    jcode, joff, jbits = jseq.read_seq_header(blob)
    pcode, poff, pbits = seqfmt.read_seq_header(blob)
    assert (poff, pbits) == (joff, jbits)
    assert np.array_equal(pcode.lengths, jcode.lengths)
    assert np.array_equal(pcode.codes, jcode.codes)
    assert pcode.max_len == jcode.max_len
    for a, b in zip(pcode.flat_lut(), jcode.flat_lut()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_table_from_length_sequence_matches_jax(seed):
    # random valid length profiles, ties in a shuffled (file) order
    rng = np.random.default_rng(seed)
    data = generate_redundant(3000, 0.3 * seed, seed=seed)
    jt = _jtable(data)
    syms = rng.permutation(jt.symtab)
    lens = jt.lengths[syms].astype(np.int64)
    order = np.argsort(lens, kind="stable")
    syms, lens = syms[order], lens[order]
    _same_table(yamamoto.table_from_length_sequence(syms, lens),
                jyam.table_from_length_sequence(syms, lens))
    # the file's tie order, not the symbol order (tests/test_interop.py)
    t = yamamoto.table_from_length_sequence(np.array([7, 3, 250, 1], np.uint8),
                                            np.array([1, 2, 3, 3]))
    assert [t.codes[s] for s in (7, 3, 250, 1)] == [0b0, 0b10, 0b110, 0b111]
    assert list(t.symtab) == [7, 3, 250, 1]


@pytest.mark.parametrize("syms,lens,match", [
    ([1, 2], [2, 1], "not ascending"),
    ([1, 2, 3], [1, 1, 1], "Kraft"),
])
def test_table_errors_match_jax(syms, lens, match):
    for mod in (yamamoto, jyam):
        with pytest.raises(ValueError, match=match):
            mod.table_from_length_sequence(np.array(syms, np.uint8),
                                           np.array(lens))


@pytest.mark.parametrize("kind", ["0.1", "0.5", "0.9", "single"])
def test_device_encoder_gives_write_yamamoto_bytes(kind):
    # one block of GapArrayCodec.encode_device at seg_bits=128 holds the
    # container's payload words and gaps (the full-size card run builds
    # its container this way)
    data = _input(kind, 12_800 if kind != "0.9" else 12_801)
    jt = _jtable(data)
    codec = GapArrayCodec(_ptable(jt), seg_bits=128,
                          block_bytes=data.size, device="cpu")
    dcomp = codec.encode_device(data)
    tb = int(dcomp.total_bits[0])
    words = dcomp.words[0, : -(-tb // 32)].numpy().view(np.uint32)
    gaps = dcomp.gaps[0, : -(-tb // 128)].numpy()
    assert (yamamoto.yamamoto_bytes(codec.table, words, gaps, data.size)
            == jyam.write_yamamoto(data, jt))


# ----------------------------------------------------------------------
# C1: segment counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["0.5", "single", "uniform", "skew16"])
@pytest.mark.parametrize("seg_bits", [128, 256])
def test_count_segments_matches_jax(kind, seg_bits):
    data, jt, pt, words, total_bits = _encoded(kind, 4000)
    gaps, counts_ref, _ = jnpref.segment_metadata(data, jt, seg_bits)
    jdec = jdevice_dec_table(jt, two_level=False)
    jspec = jdec_spec(jt)
    pspec = tt.dec_spec(pt)
    n = gaps.shape[0]
    words_j = jnp.asarray(np.concatenate([words, np.zeros(2, np.uint32)]))
    gaps_j = jnp.asarray(gaps.astype(np.int32))
    # the exact bit count and the format's word-count bound
    for bound in (total_bits, words.size * 32):
        got = gd.count_segments(
            _t32(words), torch.from_numpy(gaps.astype(np.int32)), _lim(pt),
            seg_bits=seg_bits, total_bits=bound, min_len=pspec.min_len,
            max_len=pspec.max_len).numpy()
        for method in ("canonical", "lut"):
            ref = jcount_segments(
                words_j, gaps_j, jnp.int32(bound), jdec, spec=jspec,
                seg_bits=seg_bits, max_count=seg_bits // jspec.min_len + 1,
                method=method)
            assert np.array_equal(got, np.asarray(ref)), method
        starts = np.arange(n) * seg_bits + gaps.astype(np.int64)
        budgets = np.minimum(np.r_[starts[1:], bound], bound) - starts
        ref = count_segments_pallas(
            words_j, gaps_j, jnp.asarray(budgets.astype(np.int32)), jdec,
            spec=jspec, seg_bits=seg_bits, n_segs=n, interpret=True)
        assert np.array_equal(got, np.asarray(ref)[:n])
        if bound == total_bits:
            assert np.array_equal(got, counts_ref)


def test_count_segments_caps_corrupt_gaps():
    # gaps far past the segment grid: each thread stops at count_max, and
    # negative entries read zeros before the stream
    _, _, pt, words, total_bits = _encoded("0.5", 2000)
    rng = np.random.default_rng(5)
    gaps = rng.integers(-300, 5000, 40).astype(np.int32)
    got = gd.count_segments(_t32(words), torch.from_numpy(gaps), _lim(pt),
                            seg_bits=128, total_bits=total_bits,
                            min_len=pt.min_len, max_len=pt.max_len_present)
    assert int(got.max()) <= gd.count_max(128, pt.min_len)
    assert int(got.min()) >= 0


# ----------------------------------------------------------------------
# C2: subsequence transitions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind,n", [
    ("single", 3000), ("0.9", 20_000), ("skew16", 6000),
])
def test_sync_transitions_match_jax(kind, n):
    data, jt, pt, words, total_bits = _encoded(kind, n)
    n_subseq = -(-total_bits // 1024)
    assert total_bits % 1024  # a partial last subsequence
    spec = tt.dec_spec(pt)
    lim = np.zeros((1, 32), np.uint32)
    lim[0, : jt.lim_left.shape[0]] = jt.lim_left
    ref = jsync(jnp.asarray(words), jnp.int32(total_bits), jnp.asarray(lim),
                seg_bits=1024, n_subseq=n_subseq, max_len=spec.max_len,
                min_len=spec.min_len, interpret=True)
    got = sk.sync_transitions(_t32(words), _lim(pt), total_bits=total_bits,
                              seg_bits=1024, n_subseq=n_subseq,
                              min_len=spec.min_len, max_len=spec.max_len)
    assert got.shape == (16, n_subseq) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref)[:, :n_subseq])
    # past the stream: count 0, exit 0
    past = sk.sync_transitions(_t32(words), _lim(pt), total_bits=total_bits,
                               seg_bits=1024, n_subseq=n_subseq + 3,
                               min_len=spec.min_len, max_len=spec.max_len)
    assert np.array_equal(past[:, :n_subseq].numpy(), got.numpy())
    assert not past[:, n_subseq:].any()


def _c2_model(words, lim, *, total_bits, seg_bits, n_subseq, min_len,
              max_len):
    """NumPy model of the kernel's merge rule (csrc/selfsync.cu).  One code
    length: every walk is arithmetic.  Else walk 0 runs to the end, marking
    its starts below min(seg_bits, 512); entry e = 1..15 stops at the
    first start q that walk 0 or an earlier entry reached, where entries
    mark their starts below 64 bits, and then count_e = steps_e + count_r -
    #{walk r's starts below q}, exit_e = exit_r (r the walk it met).
    Returns the (16, n_subseq) transitions and the number of entries that
    stopped so."""
    lim = np.asarray(lim, np.int64) & 0xFFFFFFFF
    w = np.asarray(words, np.uint32).astype(np.int64)
    map_bits = min(seg_bits, 512)
    out = np.zeros((16, n_subseq), np.int64)
    merges = 0

    def word(j):
        return int(w[j]) if 0 <= j < w.size else 0

    def length(pos):
        j, sh = int(pos) >> 5, int(pos) & 31
        win = (((word(j) << 32) | word(j + 1)) << sh) >> 32 & 0xFFFFFFFF
        return min_len + sum(win >= lim[l] for l in range(min_len, max_len))

    for i in range(n_subseq):
        base = i * seg_bits
        q_end = min(max(int(total_bits) - base, 0), seg_bits)
        starts = [[] for _ in range(16)]  # the marked starts of each walk
        owner = {}
        for e in range(16):
            q, count, met = e, 0, None
            if min_len == max_len:
                count = -(-(q_end - e) // max_len) if e < q_end else 0
                q = e + count * max_len
            while min_len < max_len and q < q_end:
                if e and q in owner:
                    met = owner[q]
                    break
                if q < (map_bits if e == 0 else 64):
                    owner[q] = e
                    starts[e].append(q)
                q += length(base + q)
                count += 1
            if met is None:
                out[e, i] = (min(max(q - seg_bits, 0), 15) << 16) | count
            else:
                below = sum(1 for m in starts[met] if m < q)
                r = out[met, i]
                out[e, i] = (r & ~0xFFFF) | (count + (r & 0xFFFF) - below)
                merges += 1
    return out, merges


def _c2_case(kind, n):
    """(words, total_bits, lim, min_len, max_len) of one C2 input; "random"
    is seeded random words under the r=0.5 table: no valid stream."""
    if kind == "random":
        _, _, pt, words, _ = _encoded("0.5", n)
        words = np.random.default_rng(5).integers(0, 1 << 32, words.size,
                                                  dtype=np.uint64)
        words = words.astype(np.uint32)
        total_bits = words.size * 32 - 7
    else:
        _, _, pt, words, total_bits = _encoded(kind, n)
    spec = tt.dec_spec(pt)
    return words, total_bits, _lim(pt), spec.min_len, spec.max_len


@pytest.mark.parametrize("seg_bits", [32, 64, 1024])
@pytest.mark.parametrize("kind,n", [
    ("uniform", 2001), ("single", 3000), ("skew16", 1500), ("random", 600),
    ("0.5", 1500), ("three", 2001),
])
def test_sync_merge_model_matches_plain_and_jax(kind, n, seg_bits):
    words, total_bits, lim, min_len, max_len = _c2_case(kind, n)
    n_subseq = -(-total_bits // seg_bits) + 2  # two past the stream
    assert total_bits % seg_bits  # a partial last subsequence
    kw = dict(total_bits=total_bits, seg_bits=seg_bits, n_subseq=n_subseq,
              min_len=min_len, max_len=max_len)
    model, merges = _c2_model(words, lim.numpy().view(np.uint32), **kw)
    plain = sk.sync_transitions_plain(_t32(words), lim, **kw)
    assert np.array_equal(model, plain.numpy())
    # one code length takes the closed form; else entries meet earlier walks
    assert (merges == 0) == (min_len == max_len)
    if (kind, seg_bits) in (("uniform", 1024), ("three", 64), ("three", 1024)):
        # the Pallas kernel in interpret mode, where it runs in seconds
        # (test_sync_transitions_match_jax holds the plain version to it on
        # other inputs); it takes no 32-bit subsequences
        jlim = np.zeros((1, 32), np.uint32)
        jlim[0] = lim.numpy().view(np.uint32)
        ref = jsync(jnp.asarray(words), jnp.int32(total_bits),
                    jnp.asarray(jlim), seg_bits=seg_bits, n_subseq=n_subseq,
                    max_len=max_len, min_len=min_len, interpret=True)
        assert np.array_equal(model, np.asarray(ref)[:, :n_subseq])


def test_sync_merge_model_non_monotone_limits():
    # limits that fall (no canonical table has them): the length still
    # never falls as the window grows, and the model equals the plain
    # version on random words
    rng = np.random.default_rng(6)
    words = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    lim = np.zeros(32, np.uint32)
    lim[2:8] = [0x9000_0000, 0x4000_0000, 0xC000_0000, 0xC000_0000,
                0xE000_0000, 0x2000_0000]
    kw = dict(total_bits=300 * 32 - 5, seg_bits=1024, n_subseq=10, min_len=2,
              max_len=8)
    model, merges = _c2_model(words, lim, **kw)
    plain = sk.sync_transitions_plain(_t32(words), _t32(lim), **kw)
    assert np.array_equal(model, plain.numpy()) and merges > 0


def test_sync_tile_geometry():
    # every seg_bits the wrapper accepts: multiples of 32 below 65536
    for seg_bits in range(32, 65536, 32):
        rows, map_words, smem = sk.sync_tile(seg_bits)
        assert rows == 128 and map_words == min(seg_bits // 32, 16)
        # walk 0's bitmap, the 8-word owner map and 16 records a
        # subsequence; with the static 1 KB length table within the 48 KB a
        # block takes without opting in to more
        assert smem == (map_words + 8 + 16) * rows * 4
        assert smem + 1024 <= 48 * 1024
    # the bitmap saturates at 512 bits; merges reach 511 bits, which the
    # kernel's 10-bit offset field holds
    assert sk.sync_tile(512)[1] == sk.sync_tile(544)[1] == 16


def test_sync_transitions_rejects_bad_shapes():
    w = torch.zeros(4, dtype=torch.int32)
    lim = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="lengths"):
        sk.sync_transitions(w, lim, total_bits=64, seg_bits=1024, n_subseq=1,
                            min_len=1, max_len=17)
    with pytest.raises(ValueError, match="multiple of 32"):
        sk.sync_transitions(w, lim, total_bits=64, seg_bits=1000, n_subseq=1,
                            min_len=1, max_len=8)


# ----------------------------------------------------------------------
# Composition scan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 5, 1024, 3000])
def test_compose_scan_matches_jax(n):
    rng = np.random.default_rng(17 + n)
    exits = rng.integers(0, 16, size=(n, 16)).astype(np.int32)
    got = selfsync._compose_scan(torch.from_numpy(exits)).numpy()
    assert np.array_equal(got, np.asarray(jss._compose_scan(jnp.asarray(exits))))
    assert np.array_equal(
        got, np.asarray(jss._compose_scan_packed(jnp.asarray(exits))))


def test_compose_scan_exact_beyond_float32():
    # the 110 000-row case of tests/test_interop.py: entries against a
    # serial walk, and the counts they select summed past 2^24 exactly
    rng = np.random.default_rng(16)
    n = 110_000
    exits = rng.integers(0, 16, size=(n, 16)).astype(np.int32)
    counts = rng.integers(900, 1100, size=(n, 16)).astype(np.int32)
    entry = selfsync._compose_scan(torch.from_numpy(exits)).numpy()
    state, total_ref = 0, 0
    walk = np.empty(n, np.int64)
    for i in range(n):
        walk[i] = state
        total_ref += int(counts[i, state])
        state = int(exits[i, state])
    assert np.array_equal(entry, walk)
    sel = torch.gather(torch.from_numpy(counts.T.copy()), 0,
                       torch.from_numpy(entry)[None])[0]
    assert int(sel.sum(dtype=torch.int64)) == total_ref > 10**8


# ----------------------------------------------------------------------
# The decoders end to end
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["0.1", "0.5", "0.9", "single", "uniform",
                                  "skew16"])
def test_decode_yamamoto_matches_jax(kind):
    data, jt, _, _, _ = _encoded(kind, 20_000, seed=3)
    blob = jyam.write_yamamoto(data, jt)
    gd.reset_launch_counts()
    got = yamamoto.decode_yamamoto(blob, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), data)
    assert np.array_equal(got.numpy(), jyam.decode_yamamoto(blob))
    assert gd.launch_counts()["count_segments"] == 0  # plain versions here


@pytest.mark.parametrize("kind", ["0.1", "0.5", "0.9", "single", "uniform",
                                  "skew16"])
def test_selfsync_decode_matches_jax(kind):
    # against the JAX package's serial oracle here; the JAX self-sync
    # decoder itself (a ~35 s interpret-mode compile per stream shape)
    # runs once, in test_decode_seq_matches_jax
    data, jt, pt, words, total_bits = _encoded(kind, 20_000, seed=4)
    got = selfsync.selfsync_decode_words(words, total_bits, pt, device="cpu")
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), data)
    ref = jnpref.decode_bits_serial(np.r_[words, np.zeros(1, np.uint32)],
                                    total_bits, jt)
    assert np.array_equal(got.numpy(), ref)
    # an int32 tensor of the words takes the same path
    got = selfsync.selfsync_decode_device(_t32(words), total_bits, pt)
    assert np.array_equal(got.numpy(), data)


@pytest.mark.parametrize("kind", ["0.5", "0.9", "single"])
def test_decode_seq_matches_jax(kind):
    data = _input(kind, 20_000, seed=6)
    blob = jseq.write_seq(data, _jtable(data))
    refs = [np.asarray(jseq.decode_seq(blob, device=False))]
    if kind == "0.5":
        refs.append(np.asarray(jseq.decode_seq(blob, device=True)))
    for ss in (True, False):
        got = seqfmt.decode_seq(blob, selfsync=ss, device="cpu")
        assert np.array_equal(got.numpy(), data)
        for ref in refs:
            assert np.array_equal(got.numpy(), ref)


def test_noncanonical_abca_and_empty_inputs():
    # a greedy-tree prefix code: a=1, b=00, c=01; payload "abca" = 100011
    blob = (bytes([2]) + (3).to_bytes(2, "big") + bytes([ord("a"), 1]) + b"1"
            + bytes([ord("b"), 2]) + b"00" + bytes([ord("c"), 2]) + b"01"
            + bytes([0b10001100]))
    code, _, total_bits = seqfmt.read_seq_header(blob)
    assert total_bits == 6 and not selfsync.is_canonical(code.lengths, code.codes)
    for ss in (True, False):
        assert bytes(seqfmt.decode_seq(blob, selfsync=ss, device="cpu")
                     .numpy()) == b"abca"
    assert bytes(np.asarray(jseq.decode_seq(blob))) == b"abca"
    assert seqfmt.decode_seq(b"", device="cpu").numel() == 0
    empty = np.zeros(0, np.uint8)
    jt = _jtable(generate_redundant(100, 0.5, seed=1))
    assert yamamoto.decode_yamamoto(yamamoto.write_yamamoto(empty, jt),
                                    device="cpu").numel() == 0
    pt = _ptable(jt)
    assert selfsync.selfsync_decode_words(np.zeros(1, np.uint32), 0, pt,
                                          device="cpu").numel() == 0


# ----------------------------------------------------------------------
# Errors
# ----------------------------------------------------------------------
def _with_size(blob, delta):
    blob = bytearray(blob)
    (symbol_count,) = np.frombuffer(blob[:8], np.uint64)
    off = 8 + 2 * int(symbol_count)
    orig = int(np.frombuffer(blob[off : off + 4], np.uint32)[0])
    blob[off : off + 4] = np.uint32(orig + delta).tobytes()
    return bytes(blob)


def test_yamamoto_corrupt_sizes_match_jax():
    data = generate_redundant(20_000, 0.5, seed=22)
    blob = jyam.write_yamamoto(data, _jtable(data))
    bad = _with_size(blob, 4096)
    for decode in (jyam.decode_yamamoto,
                   lambda b: yamamoto.decode_yamamoto(b, device="cpu")):
        with pytest.raises(ValueError, match="corrupt container: symbol count"):
            decode(bad)
    short = _with_size(blob, -1)
    got = yamamoto.decode_yamamoto(short, device="cpu").numpy()
    assert np.array_equal(got, jyam.decode_yamamoto(short))
    assert np.array_equal(got, data[:-1])


@pytest.mark.parametrize("buf,match", [
    (b"\x00" * 4, "truncated Yamamoto container"),
    (np.uint64(10**9).tobytes() + b"\x00" * 32, "implausible Yamamoto header"),
    (np.uint64(1).tobytes() + b"\x07\x01" + np.array([5, 3, 1], "<u4").tobytes(),
     "truncated Yamamoto container"),
])
def test_yamamoto_garbage_headers_match_jax(buf, match):
    for read in (jyam.read_yamamoto, yamamoto.read_yamamoto):
        with pytest.raises(ValueError, match=match):
            read(buf)
    with pytest.raises(ValueError, match=match):
        yamamoto.decode_yamamoto(buf, device="cpu")


@pytest.mark.parametrize("buf,match", [
    (b"\x00", "truncated sequential-format blob"),
    (b"\x08\x00\x00", "invalid padding"),
    (b"\x00\x00\x01\x41", "truncated code table"),
    (b"\x00\x00\x01\x41\x00", "invalid code entry"),
    (b"\x00\x00\x01\x41\x02\x30\x32", "invalid code character"),
    (b"\x07\x00\x00", "truncated payload"),
])
def test_seq_garbage_headers_match_jax(buf, match):
    for read in (jseq.read_seq_header, seqfmt.read_seq_header):
        with pytest.raises(ValueError, match=match):
            read(buf)
    with pytest.raises(ValueError, match=match):
        seqfmt.decode_seq(buf, device="cpu")


def test_selfsync_rejects_codes_past_16_bits_as_jax():
    syms = np.arange(18, dtype=np.uint8)
    lens = np.r_[np.arange(1, 17), 17, 17].astype(np.int64)[:18]
    words = np.zeros(4, np.uint32)
    jt = jyam.table_from_length_sequence(syms, lens)
    pt = yamamoto.table_from_length_sequence(syms, lens)
    msg = "max codeword length <= 16"
    with pytest.raises(ValueError, match=msg):
        jss.selfsync_decode_words(words, 64, jt, interpret=True)
    with pytest.raises(ValueError, match=msg):
        selfsync.selfsync_decode_words(words, 64, pt, device="cpu")
