"""CUDA kernels of huffman_tpu_torch against their plain PyTorch versions.

Needs a card: every test is marked `cuda` and skips without one.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` skips `tests/conftest.py`, which imports JAX.)

Every comparison is of integers and exact (tolerance 0).
"""

import re

import numpy as np
import pytest
import torch

from huffman_tpu_torch import IlsCodec
from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_schedule_numer
from huffman_tpu_torch.io import read_ils_container, write_ils_container
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk
from huffman_tpu_torch.ops.launch import launch
from huffman_tpu_torch.utils import generate_redundant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tk.reset_launch_counts()
    yield torch.device("cuda")
    torch.cuda.synchronize()


def _mixed(k, n_tiles):
    """Blocky heterogeneous data: zeros, a uniform region, redundant tiles."""
    n = n_tiles * k * ILS_LANES
    data = generate_redundant(n, 0.5, seed=2)
    data[: n // 4] = 0
    data[n // 4 : n // 2] = generate_redundant(n // 4, 0.0, seed=3)
    return data


def _inputs(data, k, dev):
    codec = IlsCodec.fit(data, k=k, device=dev)
    avg = float(codec.table.lengths.astype(np.int64)[data].mean())
    words = torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES).copy())
    return codec, ils_schedule_numer(avg), words.to(dev)


def _equal(got, ref):
    if isinstance(got, torch.Tensor):
        return torch.equal(got, ref)
    return all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("k", [12, 64, 256])
def test_encode_kernels_match_plain(cuda, k):
    data = _mixed(k, 3)
    codec, snum, words = _inputs(data, k, cuda)
    ml = codec.table.max_len_present
    stride_rows = max(2 * (-(-k * ml // 64)), 4)
    for rot in (False, True):
        got = tk.ils_lengths_pass(words, snum, codec.enc, k=k, rot=rot)
        ref = tk.ils_lengths_pass_plain(words, snum, codec.enc, k=k, rot=rot)
        assert _equal(got, ref)
        for anchor in ("mu", "laggard"):
            for e_band in (2, 8, 32):
                kw = dict(k=k, stride_rows=stride_rows, rot=rot,
                          anchor=anchor, e_band=e_band)
                got = tk.ils_pack_certify(words, snum, codec.enc, **kw)
                ref = tk.ils_pack_certify_plain(words, snum, codec.enc, **kw)
                assert _equal(got, ref), (rot, anchor, e_band)
        bits, dn, dx, en, ex = tk.ils_lengths_pass_plain(
            words, snum, codec.enc, k=k, rot=rot)
        w_band, boffs = tils.emission_band(en, ex)
        p = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                                 extra_band_pairs=w_band)
        boffs = torch.from_numpy(boffs).to(cuda)
        starts = tils.row_starts_of(p, cuda)
        kw = dict(k=k, w_cap=p.w_cap, w_band=w_band, total_rows=p.total_rows,
                  rot=rot)
        got = tk.ils_pack(words, snum, boffs, starts, codec.enc, **kw)
        ref = tk.ils_pack_plain(words, snum, boffs, starts, codec.enc, **kw)
        assert _equal(got, ref)
    counts = tk.launch_counts()
    assert counts["ils_lengths_pass"] == 2
    assert counts["ils_pack_certify"] == 12
    assert counts["ils_pack"] == 2


@pytest.mark.parametrize("k,r", [(12, 0.5), (256, 0.9), (256, 0.0)])
def test_decode_and_compact_match_plain(cuda, k, r):
    data = generate_redundant(3 * k * ILS_LANES, r, seed=5)
    codec, snum, words = _inputs(data, k, cuda)
    for rot in (False, True):
        rows, starts, p = tils.ils_encode_to_device(
            words, codec.enc, k=k, avg_bits=codec.fit_avg_bits,
            max_len=codec.table.max_len_present, rot=rot)
        kw = dict(k=k, w_cap=p.w_cap, n_tiles=p.n_tiles,
                  max_len=codec.table.max_len_present,
                  min_len=codec.table.min_len, rot=rot)
        got = tk.ils_decode(rows, starts, codec.dec, **kw)
        ref = tk.ils_decode_plain(rows, starts, codec.dec, **kw)
        assert _equal(got, ref)
        assert torch.equal(got, words)
        # without the slack rows: rows past the payload read as zeros
        bare = rows[: p.total_rows]
        assert torch.equal(tk.ils_decode(bare, starts, codec.dec, **kw), words)
        assert torch.equal(tk.ils_decode_plain(bare, starts, codec.dec, **kw),
                           words)
        stride_rows = tils.stride_rows_for(k, codec.table.max_len_present)
        pay = tk.ils_pack_certify(words, snum, codec.enc, k=k,
                                  stride_rows=stride_rows, rot=rot,
                                  e_band=512)[0]
        kw = dict(stride_rows=stride_rows, w_cap=p.w_cap,
                  total_rows=p.total_rows)
        got = tk.ils_compact(pay, starts, **kw)
        ref = tk.ils_compact_plain(pay, starts, **kw)
        assert _equal(got, ref)
    assert tk.launch_counts()["ils_decode"] == 4


@pytest.mark.parametrize("n_extra", [0, 1, 4095, 70000])
def test_codec_container_matches_cpu(cuda, n_extra):
    # the kernel path writes the same container bytes as the plain path
    k = 8
    data = generate_redundant(4 * k * ILS_LANES + n_extra, 0.5, seed=7)
    blobs = []
    for dev in ("cuda", "cpu"):
        codec = IlsCodec.fit(data, k=k, device=dev)
        blobs.append(write_ils_container(codec.encode(data)))
        out = codec.decode(read_ils_container(blobs[-1]))
        assert np.array_equal(out.cpu().numpy(), data)
    assert blobs[0] == blobs[1]


# a k=12 container of 2 tiles and a tail (49,757 B): section 0's k is byte
# 533 and the top byte of its w_cap byte 552; the twin of the CPU test
# tests/test_torch_ils_codec.py::test_corrupt_section_shape_raises
CORRUPT_SECTIONS = [
    (552, 0x80, "w_cap=2147483664 does not fit the kernel's int32"),
    (552, 0x8A, "w_cap=2315255824 does not fit the kernel's int32"),
    (552, 0xFF, "w_cap=4278190096 does not fit the kernel's int32"),
    (533, 12 ^ 86, "invalid decode shape k=86, max_len=9"),
]


@pytest.mark.parametrize("at,flip,error", CORRUPT_SECTIONS,
                         ids=["w_cap^0x80", "w_cap^0x8A", "w_cap^0xFF",
                              "k=86"])
def test_corrupt_section_shape_raises_on_card(cuda, at, flip, error):
    # F20: A1's int would wrap a w_cap of 2^31 or more and decode garbage;
    # it raises before the route, as on the CPU.  F19: a k that is not a
    # multiple of 4
    data = generate_redundant(25353, 0.5, seed=1)
    codec = IlsCodec.fit(data, k=12, device=cuda)
    blob = bytearray(write_ils_container(codec.encode(data)))
    assert len(blob) == 49757 and blob[533] == 12
    assert np.array_equal(
        codec.decode(read_ils_container(bytes(blob))).cpu().numpy(), data)
    blob[at] ^= flip
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match=re.escape(error)):
        codec.decode(read_ils_container(bytes(blob)))
    assert tk.launch_counts()["ils_decode"] == 0


def test_seam_range_checks_a_built_entry(cuda):
    # the seam's check on A1's own library: w_cap, argument 8, of 2^31
    # raises before the call and is not counted
    x = torch.zeros(1, device=cuda)
    args = [0] * 6 + [1, 4, 1 << 31, 1, 8, 0, 1, tk.ILS_LUT_BITS]
    with pytest.raises(ValueError, match=re.escape(
            "ils_decode: argument 8 of ils_decode_launch is 2147483648")):
        launch("ils_decode", "ils_decode_launch", *args, like=x,
               counted=tk.ils_decode)
    with pytest.raises(ValueError, match="takes 14 arguments"):
        launch("ils_decode", "ils_decode_launch", *args[:-1], like=x,
               counted=tk.ils_decode)
    assert tk.launch_counts()["ils_decode"] == 0


# ----------------------------------------------------------------------
# HTC1 kernels B1, B2, B4b-B4d
# ----------------------------------------------------------------------
def _gap_data(kind, n):
    if kind == "single":
        return np.full(n, 3, np.uint8)
    if kind == "uniform":
        return np.arange(n, dtype=np.uint8)
    return generate_redundant(n, float(kind), seed=21)


@pytest.mark.parametrize("kind,g,b,seg_bits", [
    ("0.1", 2, 8192, 1024), ("0.5", 3, 4096, 128), ("0.9", 1, 65536, 4096),
    ("single", 2, 4096, 128), ("uniform", 2, 4096, 1024),
    # 1-bit codes filling 8192-bit segments: max_count 8192, 128 chunks
    ("single", 2, 16384, 8192),
])
def test_gap_kernels_match_plain(cuda, kind, g, b, seg_bits):
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    gd.reset_launch_counts()
    ge.reset_launch_counts()
    data = _gap_data(kind, g * b)
    codec = GapArrayCodec.fit(data, seg_bits=seg_bits, block_bytes=b,
                              device=cuda)
    blocks = torch.from_numpy(data.reshape(g, b).copy()).to(cuda)
    rows = blocks.view(torch.int32).view(-1, 32)
    cap = ge.row_cap_words(codec.table.max_len_present)
    got = ge.gap_row_pack(rows, codec.enc, cap_words=cap)
    assert _equal(got, ge.gap_row_pack_plain(rows, codec.enc, cap_words=cap))
    pay, bits = got
    bits_blk = bits.view(g, -1).to(torch.int64)
    s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
    n_segs = -(-int(bits_blk.sum(1).max()) // seg_bits) + 2
    kw = dict(rows_per_block=b // 128, n_segs=n_segs, seg_bits=seg_bits)
    assert _equal(ge.gap_row_meta(rows, codec.enc, s_local,
                                  max_len=max(codec.table.max_len_present, 1),
                                  **kw),
                  ge.gap_row_meta_plain(rows, codec.enc, s_local, **kw))
    kw = dict(rows_per_block=b // 128, out_words=n_segs * seg_bits // 32 + 1)
    assert _equal(ge.gap_place_bits(pay, bits, s_local, **kw),
                  ge.gap_place_bits_plain(pay, bits, s_local, **kw))

    dcomp = codec.encode_device(blocks)
    counts = dcomp.counts
    mc = -(-int(counts.max()) // 8) * 8
    lim, bias = gd.kernel_tabs(codec.dec)
    kw = dict(seg_bits=seg_bits, max_count=mc, min_len=codec.spec.min_len,
              max_len=codec.spec.max_len)
    ranks = gd.gap_decode_ranks(dcomp.words, dcomp.gaps, counts, lim, bias, **kw)
    assert _equal(ranks, gd.gap_decode_ranks_plain(dcomp.words, dcomp.gaps,
                                                   counts, lim, bias, **kw))
    # B1's tile edges: a max_count that is a multiple of neither 4 nor the
    # column chunk (byte stores), and G blocks of a segment count that is
    # no multiple of a tile's rows, so that a tile spans two blocks
    ns = counts.shape[1]
    rows = gd.ranks_tile(mc, seg_bits)[0]
    cut = next(c for c in range(ns - 1, 0, -1) if g * c % rows)
    for gaps_e, counts_e, mc_e in ((dcomp.gaps, counts, mc + 5),
                                   (dcomp.gaps[:, :cut].contiguous(),
                                    counts[:, :cut].contiguous(), mc)):
        kw_e = dict(kw, max_count=mc_e)
        assert _equal(
            gd.gap_decode_ranks(dcomp.words, gaps_e, counts_e, lim, bias, **kw_e),
            gd.gap_decode_ranks_plain(dcomp.words, gaps_e, counts_e, lim, bias,
                                      **kw_e))
    flat = counts.reshape(-1)
    offs = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    out = gd.gap_place_bytes(ranks, flat, offs, codec.dec.symtab, n_out=g * b)
    assert _equal(out, gd.gap_place_bytes_plain(ranks, flat, offs,
                                                codec.dec.symtab, n_out=g * b))
    assert torch.equal(out, blocks.reshape(-1))
    assert torch.equal(codec.decode_device(dcomp), blocks)
    assert all(ge.launch_counts().values())
    assert gd.launch_counts()["gap_decode_ranks"] > 0
    assert gd.launch_counts()["gap_place_bytes"] > 0


@pytest.mark.parametrize("n,block_bytes,seg_bits", [
    (3 * 65536 + 777, 65536, 1024), (100000, 30000, 128), (1, 4096, 1024),
    # a 128-byte tail at byte offset 1000 (8 mod 16) and 1001 (odd)
    (1128, 1000, 1024), (1129, 1001, 1024),
    # odd block sizes and ragged tails, every block on the kernels
    (3 * 1000 + 7, 1000, 128), (2 * 129 + 5, 129, 1024),
])
def test_gap_codec_container_matches_cpu(cuda, n, block_bytes, seg_bits):
    from huffman_tpu_torch import GapArrayCodec, read_container, write_container

    data = generate_redundant(n, 0.5, seed=23)
    blobs = []
    for dev in ("cuda", "cpu"):
        codec = GapArrayCodec.fit(data, seg_bits=seg_bits,
                                  block_bytes=block_bytes, device=dev)
        blobs.append(write_container(codec.encode(data)))
        out = codec.decode(read_container(blobs[-1]))
        assert np.array_equal(out.cpu().numpy(), data)
    assert blobs[0] == blobs[1]


def test_gap_row_pack_rejects_misaligned_rows(cuda):
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    codec = GapArrayCodec.fit(np.arange(256, dtype=np.uint8), device=cuda)
    rows = torch.zeros(2 * 32 + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ge.gap_row_pack(rows.view(2, 32), codec.enc, cap_words=8)


@pytest.mark.parametrize("n_rows", [1, 3, 129, 4097])
def test_gap_row_pack_tile_edges(cuda, n_rows):
    # row counts around the rows of a block; a 16-bit-deep table (64 words
    # a row, its last row filled to them) and bytes the table lacks (length
    # 0, its last row all such); a cap_words that is no multiple of 4 (the
    # word-by-word end of a block's copy, rows cut short as in the plain
    # version)
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    rng = np.random.default_rng(n_rows)
    ge.reset_launch_counts()
    for kind, deep in (("max_len=16", 55), ("lacks", 200)):
        sample, table = _map_case(kind)
        data = rng.choice(sample, n_rows * 128)
        data[-128:] = deep
        enc = tk.ils_enc_tabs(table, device=cuda)
        rows = torch.from_numpy(data.view(np.int32).reshape(n_rows, 32)
                                .copy()).to(cuda)
        for cap in (ge.row_cap_words(table.max_len_present), 6):
            got = ge.gap_row_pack(rows, enc, cap_words=cap)
            assert len(got) == 2  # (pay, bits): no starts since B4c reads rows
            assert _equal(got, ge.gap_row_pack_plain(rows, enc, cap_words=cap)), \
                (kind, cap)
    assert ge.row_cap_words(_map_case("max_len=16")[1].max_len_present) == 64
    assert ge.launch_counts()["gap_row_pack"] == 4


@pytest.mark.parametrize("n_rows", [1, 3, 129, 4097])
def test_gap_row_meta_place_bits_edges(cuda, n_rows):
    # B4c and B4d at row counts around their tiles, with HTC1 blocks of 1,
    # 32, 512 and n_rows rows (the rows rounded up to whole blocks: tiles
    # cut at a block's end); a 16-bit-deep table and one lacking bytes
    # (length 0, a row of them all: 128 starts at one bit, 0 bits placed);
    # seg_bits 8 (tiles of 16 rows, runs cut mid-segment), 128, 1024 and
    # 8192; n_segs and out_words cut short; a row of 0 bits whose words
    # are not zero; B4d also at cap_words 6
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    rng = np.random.default_rng(n_rows + 7)
    ge.reset_launch_counts()
    calls = 0
    for kind, deep in (("max_len=16", 55), ("lacks", 200)):
        sample, table = _map_case(kind)
        enc = tk.ils_enc_tabs(table, device=cuda)
        max_len = max(table.max_len_present, 1)
        cap = ge.row_cap_words(max_len)
        for rpb in (1, 32, 512, n_rows):
            n = -(-n_rows // rpb) * rpb
            data = rng.choice(sample, n * 128)
            data[-128:] = deep
            if n > 2:
                data[128:256] = deep
            rows = torch.from_numpy(data.view(np.int32).reshape(n, 32)
                                    .copy()).to(cuda)
            pay, bits = ge.gap_row_pack(rows, enc, cap_words=cap)
            bits_blk = bits.view(-1, rpb).to(torch.int64)
            s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
            top = int(bits_blk.sum(1).max())
            for seg_bits in (8, 128, 1024, 8192):
                full = -(-top // seg_bits) + 1
                for n_segs in (full, max(full // 2, 1)):
                    kw = dict(rows_per_block=rpb, n_segs=n_segs,
                              seg_bits=seg_bits)
                    assert _equal(
                        ge.gap_row_meta(rows, enc, s_local, max_len=max_len,
                                        **kw),
                        ge.gap_row_meta_plain(rows, enc, s_local, **kw)), \
                        (kind, rpb, seg_bits, n_segs)
                    calls += 1
            zeroed = bits.clone()
            zeroed[n // 2] = 0
            # cap_words 6: rows cut short, no 16-byte quads (word loads)
            pay6, bits6 = ge.gap_row_pack(rows, enc, cap_words=6)
            for out_words in (top // 32 + 2, max(top // 64, 1)):
                for p, b in ((pay, bits), (pay, zeroed), (pay6, bits6)):
                    kw = dict(rows_per_block=rpb, out_words=out_words)
                    assert _equal(
                        ge.gap_place_bits(p, b, s_local, **kw),
                        ge.gap_place_bits_plain(p, b, s_local, **kw)), \
                        (kind, rpb, out_words, p.shape[1])
    assert ge.launch_counts()["gap_row_meta"] == calls
    assert ge.launch_counts()["gap_place_bits"] == 2 * 4 * 2 * 3


def test_gap_decode_kernels_stay_inside_buffers(cuda):
    # corrupt metadata (negative gaps, counts past max_count or negative,
    # offsets outside the output) is clamped in the kernels as in the
    # plain versions: no fault, the same bytes
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.ops import gap_decode_kernels as gd

    rng = np.random.default_rng(3)
    codec = GapArrayCodec.fit(generate_redundant(5000, 0.5, seed=4),
                              device=cuda)
    g, ns, nw = 2, 64, 50
    words = torch.from_numpy(
        rng.integers(0, 2**32, (g, nw), dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(cuda)
    gaps = torch.from_numpy(rng.integers(-40, 40, (g, ns)).astype(np.int32)).to(cuda)
    counts = torch.from_numpy(rng.integers(-5, 300, (g, ns)).astype(np.int32)).to(cuda)
    lim, bias = gd.kernel_tabs(codec.dec)
    # 64 is one column chunk of B1's tile; 37 and 100 end in a partial one.
    # The walks leave their staged rows (counts past a segment's bits,
    # gaps before it or past it) and read device memory
    for mc in (64, 37, 100):
        kw = dict(seg_bits=128, max_count=mc, min_len=codec.spec.min_len,
                  max_len=codec.spec.max_len)
        ranks = gd.gap_decode_ranks(words, gaps, counts, lim, bias, **kw)
        assert _equal(ranks, gd.gap_decode_ranks_plain(words, gaps, counts,
                                                       lim, bias, **kw))
        flat = counts.reshape(-1)
        kept = flat.clamp(0, mc).to(torch.int64)
        offs = torch.cumsum(kept, 0) - kept - 500  # disjoint, some outside
        out = gd.gap_place_bytes(ranks, flat, offs, codec.dec.symtab,
                                 n_out=1500)
        assert _equal(out, gd.gap_place_bytes_plain(ranks, flat, offs,
                                                    codec.dec.symtab,
                                                    n_out=1500))
    # B1 staged at 1024 bits and 8 bits, unstaged at 8192: gaps far outside
    # their segments, words cut short of the segments
    for seg_bits, mc in ((1024, 200), (8, 300), (8192, 64)):
        far = torch.from_numpy(rng.integers(
            -3 * seg_bits, 3 * seg_bits, (g, ns)).astype(np.int32)).to(cuda)
        for w in (words, words[:, :7].contiguous()):
            kw = dict(seg_bits=seg_bits, max_count=mc,
                      min_len=codec.spec.min_len, max_len=codec.spec.max_len)
            assert _equal(
                gd.gap_decode_ranks(w, far, counts, lim, bias, **kw),
                gd.gap_decode_ranks_plain(w, far, counts, lim, bias, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("seg_bits", [128, 1024, 8192])
def test_gap_decode_ranks_staged_tiles_match_plain(cuda, seg_bits):
    # B1's staged words on valid streams (staged at 128 and 1024 bits, read
    # from device memory at 8192): three blocks of a segment count that is
    # no multiple of a warp's rows (tiles and warps cross from one payload
    # block into the next), and a block shorter than the others, whose
    # segments read zeros past its words
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.core import npref
    from huffman_tpu_torch.ops import gap_decode_kernels as gd

    parts = [generate_redundant(m, 0.3, seed=31 + i)
             for i, m in enumerate((20000, 23011, 9001))]
    codec = GapArrayCodec.fit(np.concatenate(parts), seg_bits=seg_bits,
                              device=cuda)
    cases = [npref.encode_bits(d, codec.table)[0] for d in parts]
    metas = [npref.segment_metadata(d, codec.table, seg_bits) for d in parts]
    nw = max(w.size for w in cases)
    ns = max(m[0].size for m in metas)
    words = np.zeros((3, nw), np.uint32)
    gaps = np.zeros((3, ns), np.int32)
    counts = np.zeros((3, ns), np.int32)
    for i, (w, (gp, c, _)) in enumerate(zip(cases, metas)):
        words[i, : w.size], gaps[i, : gp.size], counts[i, : c.size] = w, gp, c
    mc = -(-int(counts.max()) // 8) * 8
    rows, _, pitch, _ = gd.ranks_tile(mc, seg_bits)
    assert (pitch > 0) == (seg_bits <= 1024) and ns % 32 and ns > 8
    lim, bias = gd.kernel_tabs(codec.dec)
    kw = dict(seg_bits=seg_bits, max_count=mc, min_len=codec.spec.min_len,
              max_len=codec.spec.max_len)
    args = [torch.from_numpy(a).to(cuda)
            for a in (words.view(np.int32), gaps, counts)]
    got = gd.gap_decode_ranks(*args, lim, bias, **kw)
    assert _equal(got, gd.gap_decode_ranks_plain(*args, lim, bias, **kw))
    rank_of = np.zeros(256, np.int64)
    rank_of[codec.table.symtab] = np.arange(codec.table.num_symbols)
    ranks = got.cpu().numpy()
    dec = np.concatenate([ranks[s, : counts.reshape(-1)[s]]
                          for s in range(3 * ns)])
    assert np.array_equal(dec, rank_of[np.concatenate(parts)] & 255)


# ----------------------------------------------------------------------
# Foreign streams: C1 (Yamamoto counts), C2 (self-sync transitions)
# ----------------------------------------------------------------------
def _foreign(kind, n):
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.core import npref

    data = _gap_data(kind, n)
    table = GapArrayCodec.fit(data, device="cpu").table
    words, total_bits = npref.encode_bits(data, table)
    return data, table, words[:-1], total_bits


@pytest.mark.parametrize("kind,n", [
    ("0.1", 40000), ("0.5", 100001), ("0.9", 30000), ("single", 5000),
    ("uniform", 7777),
])
def test_foreign_kernels_match_plain(cuda, kind, n):
    from huffman_tpu_torch.core import npref
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops import selfsync_kernels as sk
    from huffman_tpu_torch.ops.tables import device_dec_table

    data, table, words, total_bits = _foreign(kind, n)
    lim = gd.kernel_tabs(device_dec_table(table, device=cuda))[0]
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    lens = dict(min_len=table.min_len, max_len=table.max_len_present)
    gd.reset_launch_counts()
    sk.reset_launch_counts()
    for seg_bits in (128, 256, 1024):
        gaps = npref.segment_metadata(data, table, seg_bits)[0]
        gaps = torch.from_numpy(gaps.astype(np.int32)).to(cuda)
        for bound in (total_bits, words.size * 32):
            kw = dict(seg_bits=seg_bits, total_bits=bound, **lens)
            got = gd.count_segments(w, gaps, lim, **kw)
            assert _equal(got, gd.count_segments_plain(w, gaps, lim, **kw))
    # corrupt gaps: capped counts, reads outside the stream are zeros
    rng = np.random.default_rng(9)
    bad = torch.from_numpy(rng.integers(-3000, 3000, 999).astype(np.int32)).to(cuda)
    kw = dict(seg_bits=128, total_bits=total_bits, **lens)
    assert _equal(gd.count_segments(w, bad, lim, **kw),
                  gd.count_segments_plain(w, bad, lim, **kw))
    n_subseq = -(-total_bits // 1024)
    for extra in (0, 5):
        kw = dict(total_bits=total_bits, seg_bits=1024,
                  n_subseq=n_subseq + extra, **lens)
        got = sk.sync_transitions(w, lim, **kw)
        assert _equal(got, sk.sync_transitions_plain(w, lim, **kw))
    assert gd.launch_counts()["count_segments"] == 7
    assert sk.launch_counts()["sync_transitions"] == 2


@pytest.mark.parametrize("seg_bits", [128, 1024])
@pytest.mark.parametrize("kind", ["0.5", "skew16", "uniform", "single"])
def test_count_segments_redesign_matches_plain(cuda, kind, seg_bits):
    # C1's count table at the Yamamoto path's 128-bit segments (4 MiB of
    # r=0.5) and at 1024 bits; skew16's limits are not byte-aligned, so
    # some prefixes decide nothing; uniform and single have one length
    # (closed form).  A few gaps corrupted, and a bound past the words
    # (zeros there).
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.core import npref
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops.tables import device_dec_table

    n = 4 << 20 if kind == "0.5" else 1 << 20
    if kind == "skew16":
        data, table = _skew16(n, 31)
    else:
        data = _gap_data(kind, n)
        table = GapArrayCodec.fit(data, device="cpu").table
    words, total_bits = npref.encode_bits(data, table)
    words = words[:-1]
    gaps, counts, _ = npref.segment_metadata(data, table, seg_bits)
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    lim = gd.kernel_tabs(device_dec_table(table, device=cuda))[0]
    lens = dict(min_len=table.min_len, max_len=table.max_len_present)
    rng = np.random.default_rng(seg_bits)
    bad = gaps.astype(np.int64) + np.where(
        rng.random(gaps.size) < 0.01, rng.integers(-3000, 3000, gaps.size), 0)
    gd.reset_launch_counts()
    for g in (gaps, bad):
        gt = torch.from_numpy(g.astype(np.int32)).to(cuda)
        for bound in (total_bits, words.size * 32 + 100):
            kw = dict(seg_bits=seg_bits, total_bits=bound, **lens)
            got = gd.count_segments(w, gt, lim, **kw)
            assert _equal(got, gd.count_segments_plain(w, gt, lim, **kw)), bound
            if g is gaps and bound == total_bits:
                assert np.array_equal(got.cpu().numpy(), counts)
    assert gd.launch_counts()["count_segments"] == 4


@pytest.mark.parametrize("kind,n", [("0.5", 300001), ("single", 20000),
                                    ("uniform", 4096), ("0.9", 1)])
def test_foreign_decoders_match_cpu(cuda, kind, n):
    from huffman_tpu_torch import (
        decode_seq,
        decode_yamamoto,
        selfsync_decode_words,
        write_seq,
        write_yamamoto,
    )
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops import selfsync_kernels as sk

    data, table, words, total_bits = _foreign(kind, n)
    gd.reset_launch_counts()
    sk.reset_launch_counts()
    blob = write_yamamoto(data, table)
    got = decode_yamamoto(blob)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), decode_yamamoto(blob, device="cpu"))
    assert np.array_equal(got.cpu().numpy(), data)
    assert gd.launch_counts()["count_segments"] == 1
    got = selfsync_decode_words(words, total_bits, table)
    assert torch.equal(got.cpu(), selfsync_decode_words(words, total_bits,
                                                        table, device="cpu"))
    assert np.array_equal(got.cpu().numpy(), data)
    assert sk.launch_counts()["sync_transitions"] == 1
    seq = write_seq(data, table)
    assert np.array_equal(decode_seq(seq).cpu().numpy(), data)
    assert gd.launch_counts()["gap_decode_ranks"] == 3


# ----------------------------------------------------------------------
# The portability path: B5, encode_block_fast, the step decoders, D1
# ----------------------------------------------------------------------
def _map_case(kind):
    from huffman_tpu_torch import GapArrayCodec

    if kind == "lacks":  # a group of bytes the table lacks: length 0
        data = generate_redundant(8192, 0.5, seed=25)
        table = GapArrayCodec.fit(np.where(data >= 200, 65, data)
                                  .astype(np.uint8), device="cpu").table
        data[100:104] = [200, 201, 250, 255]
        return data, table
    if kind == "max_len=16":
        from huffman_tpu_torch.io import table_from_length_sequence

        syms = np.r_[np.arange(40, 55), 56, 55].astype(np.uint8)
        lens = np.r_[np.arange(1, 16), 16, 16]
        p = 2.0 ** -np.arange(1, 18)
        rng = np.random.default_rng(26)
        data = syms[rng.choice(17, size=8192, p=p / p.sum())]
        return data, table_from_length_sequence(syms, lens)
    data = _gap_data(kind, 8192)
    return data, GapArrayCodec.fit(data, device="cpu").table


@pytest.mark.parametrize("kind", ["0.1", "0.5", "0.9", "single", "uniform",
                                  "max_len=16", "lacks"])
def test_encode_map_and_encode_block_fast_match(cuda, kind):
    from huffman_tpu_torch.ops import encode as tenc
    from huffman_tpu_torch.ops import encode_map_kernels as em

    data, table = _map_case(kind)
    d = torch.from_numpy(data).to(cuda)
    enc = tk.ils_enc_tabs(table, device=cuda)
    em.reset_launch_counts()
    assert _equal(em.encode_map(d, enc), em.encode_map_plain(d, enc))
    assert em.launch_counts() == {"encode_map": 1}
    total = int(table.lengths.astype(np.int64)[data].sum())
    for seg_bits in (128, 1024):
        kw = dict(seg_bits=seg_bits, max_words=-(-total // 32) + 3,
                  n_segs=-(-total // seg_bits) + 2)
        assert _equal(tenc.encode_block_fast(d, enc, **kw),
                      tenc.encode_block(d, enc, **kw))
    with pytest.raises(ValueError, match="4-byte boundary"):
        em.encode_map(torch.zeros(4097, dtype=torch.uint8,
                                  device=cuda)[1:], enc)


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
def test_gap_codec_methods_round_trip_on_card(cuda, method):
    from huffman_tpu_torch import (
        GapArrayCodec,
        decode_yamamoto,
        read_container,
        write_container,
        write_yamamoto,
    )

    data = generate_redundant(3 * 16384 + 999, 0.5, seed=27)
    codec = GapArrayCodec.fit(data, block_bytes=16384, method=method,
                              device=cuda)
    out = codec.decode(read_container(write_container(codec.encode(data))))
    assert out.device.type == "cuda"
    assert np.array_equal(out.cpu().numpy(), data)
    blocks = torch.from_numpy(data[: 3 * 16384].reshape(3, 16384)).to(cuda)
    assert torch.equal(codec.decode_device(codec.encode_device(blocks)), blocks)
    blob = write_yamamoto(data, codec.table)
    if method == "twolevel":
        with pytest.raises(ValueError, match="two-level form"):
            decode_yamamoto(blob, method=method)
    else:
        got = decode_yamamoto(blob, method=method)
        assert np.array_equal(got.cpu().numpy(), data)


@pytest.mark.parametrize("anchor", ["mu", "laggard"])
def test_stream_pack_matches_plain_and_a2(cuda, anchor):
    k, stride = 256, 128
    codec, snum, words = _inputs(generate_redundant(2 * k * ILS_LANES, 0.5,
                                                    seed=21), k, cuda)
    kw = dict(k=k, stride_rows=stride, chunk_cap=8, anchor=anchor)
    got = tk.ils_pack_certify_stream(words, snum, codec.enc, **kw)
    assert tk.launch_counts()["ils_pack_certify_stream"] == 1
    assert _equal(got, tk.ils_pack_certify_stream_plain(words, snum, codec.enc,
                                                        **kw))
    a2 = tk.ils_pack_certify(words, snum, codec.enc, k=k, stride_rows=stride,
                             anchor=anchor)
    assert _equal(got[1:], a2[1:])
    for t in range(2):
        w_t = 2 * (-(-int(got[1][t].max()) // 64))
        rows = slice(t * stride, t * stride + w_t)
        assert torch.equal(got[0][rows], a2[0][rows])


# ----------------------------------------------------------------------
# C2 with reference walks and merges, A1 with its length-and-symbol table
# ----------------------------------------------------------------------
def _skew16(n, seed):
    """A max_len=16 table (every length 1..16) and n bytes drawn from it."""
    from huffman_tpu_torch.io import table_from_length_sequence

    syms = np.r_[np.arange(40, 55), 56, 55].astype(np.uint8)
    lens = np.r_[np.arange(1, 16), 16, 16]
    p = 2.0 ** -np.arange(1, 18)
    rng = np.random.default_rng(seed)
    data = syms[rng.choice(17, size=n, p=p / p.sum())]
    return data, table_from_length_sequence(syms, lens)


def _sync_case(kind, bits):
    """(words, total_bits, table) of about `bits` stream bits, the last
    subsequence partial at every seg_bits of the tests; "random" is seeded
    random words under an r=0.5 table, no valid stream."""
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.core import npref

    per_symbol = {"single": 1, "uniform": 8, "skew16": 2}.get(kind, 4)
    n = bits // per_symbol + 3
    if kind == "skew16":
        data, table = _skew16(n, 27)
    else:
        data = _gap_data("0.5" if kind == "random" else kind, n)
        table = GapArrayCodec.fit(data, device="cpu").table
    words, total_bits = npref.encode_bits(data, table)
    words = words[:-1]
    if kind == "random":
        rng = np.random.default_rng(28)
        words = rng.integers(0, 1 << 32, words.size, dtype=np.uint64)
        words = words.astype(np.uint32)
        total_bits = words.size * 32 - 7
    return words, int(total_bits), table


@pytest.mark.parametrize("kind,seg_bits", [
    *[(kind, s) for kind in ("uniform", "single", "skew16", "random", "0.5")
      for s in (32, 1024, 8192)],
    ("uniform", 65504), ("random", 65504), ("0.5", 65504),
    # walk 0's bitmap as wide as the owner map, and just past 512 bits
    ("0.5", 64), ("0.5", 544),
])
def test_sync_transitions_redesign_match_plain(cuda, kind, seg_bits):
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops import selfsync_kernels as sk
    from huffman_tpu_torch.ops.tables import device_dec_table

    words, total_bits, table = _sync_case(kind, max(300_000, 3 * seg_bits))
    if total_bits % seg_bits == 0:
        total_bits -= 5
    lim = gd.kernel_tabs(device_dec_table(table, device=cuda))[0]
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    lens = dict(min_len=table.min_len, max_len=table.max_len_present)
    sk.reset_launch_counts()
    # past the stream; and a view one word in
    for ww, tb, extra in ((w, total_bits, 0), (w, total_bits, 5),
                          (w[1:], total_bits - 32, 0)):
        kw = dict(total_bits=tb, seg_bits=seg_bits,
                  n_subseq=-(-tb // seg_bits) + extra, **lens)
        got = sk.sync_transitions(ww, lim, **kw)
        assert _equal(got, sk.sync_transitions_plain(ww, lim, **kw)), extra
    assert got.shape == (16, -(-(total_bits - 32) // seg_bits))
    assert sk.launch_counts()["sync_transitions"] == 3


@pytest.mark.parametrize("n_words", [128 * 32, 128 * 32 + 4, 129 * 32 + 1])
def test_sync_transitions_tile_edges(cuda, n_words):
    # 1024-bit subsequences: one full block of 128, its last subsequence
    # reading words past the stream (zeros), and a block of one
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops import selfsync_kernels as sk
    from huffman_tpu_torch.ops.tables import device_dec_table

    rng = np.random.default_rng(n_words)
    words = rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
    w = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(cuda)
    table = GapArrayCodec.fit(_gap_data("0.9", 4096), device="cpu").table
    lim = gd.kernel_tabs(device_dec_table(table, device=cuda))[0]
    for tb in (n_words * 32, n_words * 32 - 1000):
        kw = dict(total_bits=tb, seg_bits=1024, n_subseq=-(-tb // 1024),
                  min_len=table.min_len, max_len=table.max_len_present)
        assert _equal(sk.sync_transitions(w, lim, **kw),
                      sk.sync_transitions_plain(w, lim, **kw))


def _ils_lut_case(kind, n):
    from huffman_tpu_torch import GapArrayCodec

    if kind == "skew16":
        return _skew16(n, 29)
    data = _gap_data(kind, n)
    return data, GapArrayCodec.fit(data, device="cpu").table


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("kind", ["skew16", "single", "uniform", "0.9"])
def test_ils_decode_redesign_matches_plain(cuda, kind, k):
    # codes longer than the table's 11 bits (skew16), min_len = max_len = 1,
    # 8-bit codes, r = 0.9; rotation off and on; with and without the slack
    # rows past the payload
    data, table = _ils_lut_case(kind, 3 * k * ILS_LANES)
    codec = IlsCodec(table, k=k, device=cuda)
    words = torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES)
                             .copy()).to(cuda)
    avg = float(table.lengths.astype(np.int64)[data].mean())
    if kind == "skew16":
        assert table.max_len_present > tk.ILS_LUT_BITS
    for rot in (False, True):
        rows, starts, p = tils.ils_encode_to_device(
            words, codec.enc, k=k, avg_bits=avg,
            max_len=table.max_len_present, rot=rot)
        kw = dict(k=k, w_cap=p.w_cap, n_tiles=p.n_tiles,
                  max_len=table.max_len_present, min_len=table.min_len,
                  rot=rot)
        for pay in (rows, rows[: p.total_rows]):
            got = tk.ils_decode(pay, starts, codec.dec, **kw)
            assert _equal(got, tk.ils_decode_plain(pay, starts, codec.dec, **kw))
            assert torch.equal(got, words)
    assert tk.launch_counts()["ils_decode"] == 4


# ----------------------------------------------------------------------
# A2 over chunked streams, B2 a block per run of segments
# ----------------------------------------------------------------------
def _a2_case(kind, k, dev):
    """(codec, snum, words) of 2 tiles at k: "mixed" is `_mixed`; "lacks"
    fits the table without bytes >= 200 and fills body rows 128-255 of
    tile 0 with such bytes (no code bits: at k=4096 the seed of every
    stream's second chunk walks back over them)."""
    data = _mixed(k, 2)
    if kind == "mixed":
        return _inputs(data, k, dev)
    data = np.where(data >= 200, 65, data).astype(np.uint8)
    codec = IlsCodec.fit(data, k=k, device=dev)
    snum = ils_schedule_numer(
        float(codec.table.lengths.astype(np.int64)[data].mean()))
    rows = data.view(np.int32).reshape(-1, ILS_LANES).copy()
    rows[128:256] = np.int32(-0x36363637)  # 0xC9C9C9C9: byte 201
    return codec, snum, torch.from_numpy(rows).to(dev)


@pytest.mark.parametrize("kind", ["mixed", "lacks"])
@pytest.mark.parametrize("rot", [False, True])
def test_pack_certify_chunked_matches_plain(cuda, kind, rot):
    # k=4096: C = certify_chunks(k) > 1 chunks a stream; every output of
    # the tuple (strided payload, bits, envelopes, flags) bit for bit
    k = 4096
    assert tk.certify_chunks(k)[0] >= 2
    codec, snum, words = _a2_case(kind, k, cuda)
    stride_rows = tils.stride_rows_for(k, codec.table.max_len_present)
    flags = {}
    for anchor in ("mu", "laggard"):
        for e_band in (2, 8, 32):
            kw = dict(k=k, stride_rows=stride_rows, rot=rot, anchor=anchor,
                      e_band=e_band)
            got = tk.ils_pack_certify(words, snum, codec.enc, **kw)
            ref = tk.ils_pack_certify_plain(words, snum, codec.enc, **kw)
            assert _equal(got, ref), (anchor, e_band)
            flags[anchor, e_band] = int(got[4].max())
    # the band of 2 pairs is left somewhere: the dropped pairs and the
    # flags of a violating call are held too
    assert flags["mu", 2] == 1
    assert tk.launch_counts()["ils_pack_certify"] == 6


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("kind", ["mixed", "lacks"])
@pytest.mark.parametrize("k", [4096, 8192])
def test_pack_chunked_matches_plain(cuda, k, kind, rot):
    # A5 over certify_chunks(k) chunks a stream (4 at k=4096, 8 at 8192):
    # A4's anchors as the two-pass tier gives them; the anchors made to
    # fall at every odd window, with the row starts moved so that pairs lie
    # outside the payload (skipped); with rotation also at a band over 192
    # pairs (G = 1)
    codec, snum, words = _a2_case(kind, k, cuda)
    assert tk.certify_chunks(k)[0] > 1
    bits, dn, dx, en, ex = tk.ils_lengths_pass(words, snum, codec.enc, k=k,
                                               rot=rot)
    band, boffs = tils.emission_band(en, ex)
    p = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                             extra_band_pairs=band)
    starts = p.row_starts[:-1].astype(np.int32)
    odd = np.arange(boffs.shape[1]) % 2 == 1
    fall = (boffs + np.where(odd, -6, 6)).astype(np.int32)
    cases = [(boffs, starts, band),
             (fall, starts + np.array([-6, 10], np.int32), band)]
    if rot:
        cases.append((fall, starts, 200))
    for b, st, w_band in cases:
        kw = dict(k=k, w_cap=max(p.w_cap, 2 * (w_band + 64)), w_band=w_band,
                  total_rows=p.total_rows, rot=rot)
        bt, stt = torch.from_numpy(b).to(cuda), torch.from_numpy(st).to(cuda)
        got = tk.ils_pack(words, snum, bt, stt, codec.enc, **kw)
        ref = tk.ils_pack_plain(words, snum, bt, stt, codec.enc, **kw)
        assert _equal(got, ref), w_band
    assert tk.launch_counts()["ils_pack"] == len(cases)


def test_stream_pack_chunked_matches_plain_and_a2(cuda):
    # D1 through A2's chunked kernels: k=4096, chunk_cap=64
    k = 4096
    codec, snum, words = _inputs(generate_redundant(2 * k * ILS_LANES, 0.5,
                                                    seed=22), k, cuda)
    stride = tils.stride_rows_for(k, codec.table.max_len_present)
    for anchor in ("mu", "laggard"):
        kw = dict(k=k, stride_rows=stride, chunk_cap=64, anchor=anchor)
        got = tk.ils_pack_certify_stream(words, snum, codec.enc, **kw)
        assert _equal(got, tk.ils_pack_certify_stream_plain(
            words, snum, codec.enc, **kw))
        a2 = tk.ils_pack_certify(words, snum, codec.enc, k=k,
                                 stride_rows=stride, anchor=anchor)
        assert _equal(got[1:], a2[1:])
        for t in range(2):
            w_t = 2 * (-(-int(got[1][t].max()) // 64))
            rows = slice(t * stride, t * stride + w_t)
            assert torch.equal(got[0][rows], a2[0][rows])
    assert tk.launch_counts()["ils_pack_certify_stream"] == 2


@pytest.mark.parametrize("kind,seg_bits", [("0.5", 128), ("0.9", 1024),
                                           ("single", 8192)])
def test_place_bytes_runs_match_plain(cuda, kind, seg_bits):
    # offsets from a real decode_blocks; then n_out cut short, zero counts,
    # a count above max_count (clamped: the offsets, the prefix sum of the
    # counts, leave a gap there) and offsets shifted to start before the
    # output
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.ops import gap_decode_kernels as gd

    g, b = 3, 65536
    data = _gap_data(kind, g * b)
    codec = GapArrayCodec.fit(data, seg_bits=seg_bits, block_bytes=b,
                              device=cuda)
    blocks = torch.from_numpy(data.reshape(g, b).copy()).to(cuda)
    dcomp = codec.encode_device(blocks)
    counts = dcomp.counts
    mc = -(-int(counts.max()) // 8) * 8
    lim, bias = gd.kernel_tabs(codec.dec)
    ranks = gd.gap_decode_ranks(dcomp.words, dcomp.gaps, counts, lim, bias,
                                seg_bits=seg_bits, max_count=mc,
                                min_len=codec.spec.min_len,
                                max_len=codec.spec.max_len)
    sym = codec.dec.symtab
    flat = counts.reshape(-1).contiguous()
    offs = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    gd.reset_launch_counts()
    out = gd.gap_place_bytes(ranks, flat, offs, sym, n_out=g * b)
    assert torch.equal(out, blocks.reshape(-1))
    rng = np.random.default_rng(seg_bits)
    zeroed = flat.clone()
    zeroed[torch.from_numpy(rng.random(flat.numel()) < 0.2).to(cuda)] = 0
    over = flat.clone()
    over[flat.numel() // 2] = mc + 7
    z_offs = torch.cumsum(zeroed, 0, dtype=torch.int64) - zeroed
    o_offs = torch.cumsum(over, 0, dtype=torch.int64) - over
    cases = [(flat, offs, g * b - 12345), (flat, offs, 1),
             (zeroed, z_offs, int(zeroed.sum())),
             (over, o_offs, int(over.sum())), (flat, offs - 777, g * b)]
    for c, o, n_out in cases:
        assert _equal(gd.gap_place_bytes(ranks, c, o, sym, n_out=n_out),
                      gd.gap_place_bytes_plain(ranks, c, o, sym, n_out=n_out))
    assert gd.launch_counts()["gap_place_bytes"] == 1 + len(cases)


def test_place_bytes_column_chunks_match_plain(cuda):
    # rows wider than B2's tile go one at a time in column chunks: counts
    # in the first chunk, across it, filling the row, zero and above
    # max_count; offsets the prefix sum, then shifted before the output
    from huffman_tpu_torch.ops import gap_decode_kernels as gd

    mc = gd.PLACE_TILE + 7232
    assert gd.place_tile(mc)[:2] == (1, gd.PLACE_TILE)
    rng = np.random.default_rng(29)
    counts = np.array([100, gd.PLACE_TILE + 5, mc, 0, mc + 9, 7],
                      dtype=np.int32)
    ranks = torch.from_numpy(rng.integers(0, 256, (counts.size, mc),
                                          dtype=np.uint8)).to(cuda)
    sym = torch.from_numpy(rng.permutation(256).astype(np.int32)).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    offs = torch.cumsum(c, 0, dtype=torch.int64) - c
    gd.reset_launch_counts()
    for o, n_out in ((offs, int(counts.sum())), (offs - 333, 70000)):
        assert _equal(gd.gap_place_bytes(ranks, c, o, sym, n_out=n_out),
                      gd.gap_place_bytes_plain(ranks, c, o, sym, n_out=n_out))
    assert gd.launch_counts()["gap_place_bytes"] == 2


# ----------------------------------------------------------------------
# A4 over (tile, chunk), its chunk bits handed to A5
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k,n_tiles,kind,rot", [
    (4096, 4, "0.5", False), (4096, 4, "0.5", True), (8, 1, "0.5", False),
    (4096, 64, "0.5", False), (8192, 32, "0.5", False),
    (262148, 1, "0.0", False), (4096, 2, "lacks", True),
    (1300, 3, "mixed", True),
])
def test_lengths_chunked_matches_plain(cuda, k, n_tiles, kind, rot):
    # the shapes of the main paths: 4 tiles at k=4096, the k=8 tail, the
    # 256 MiB section at k=4096 and at optimize="ratio" (32 tiles at
    # k=8192), one tile at k=262,148 (the file path's first attempt on a
    # 256 MiB + 777 B file: 257 chunks; uniform bytes, 8-bit codes, put
    # i * snum at 2^31 in its last body);
    # windows without a retiring pair ("lacks"), a short last chunk (k=1300)
    if kind == "lacks":
        codec, snum, words = _a2_case(kind, k, cuda)
    else:
        data = (_mixed(k, n_tiles) if kind == "mixed" else
                generate_redundant(n_tiles * k * ILS_LANES, float(kind),
                                   seed=k))
        codec, snum, words = _inputs(data, k, cuda)
    C = tk.certify_chunks(k)[0]
    got = tk.ils_lengths_pass(words, snum, codec.enc, k=k, rot=rot,
                              chunk_bits=True)
    assert tk.launch_counts()["ils_lengths_pass"] == 1
    ref = tk.ils_lengths_pass_plain(words, snum, codec.enc, k=k, rot=rot)
    assert _equal(got[:5], ref)
    assert tuple(got[5].shape) == (n_tiles, C - 1, ILS_LANES)
    assert torch.equal(got[5], tk.ils_chunk_bits_plain(words, codec.enc, k=k,
                                                       rot=rot))
    if k == 262148:
        assert C == 257 and (k // 4 - 1) * snum >= 1 << 31
        return
    bits, dn, dx, en, ex, cbits = got
    band, boffs = tils.emission_band(en, ex)
    p = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                             extra_band_pairs=band)
    args = (words, snum, torch.from_numpy(boffs).to(cuda),
            tils.row_starts_of(p, cuda), codec.enc)
    kw = dict(k=k, w_cap=p.w_cap, w_band=band, total_rows=p.total_rows,
              rot=rot)
    with_bits = tk.ils_pack(*args, cbits=cbits, **kw)
    assert torch.equal(with_bits, tk.ils_pack(*args, **kw))
    assert torch.equal(with_bits, tk.ils_pack_plain(*args, **kw))


# ----------------------------------------------------------------------
# B4b and B4c with byte counts: blocks of any size on the kernels
# ----------------------------------------------------------------------
def _byte_count_case(cuda, kind, counts, b, seed):
    """(rows, enc, n_bytes, max_len) on the card: len(counts) blocks of
    b bytes (b a multiple of 128) of `kind` (`_map_case`'s tables) and
    their byte counts."""
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    sample, table = _map_case(kind)
    data = np.random.default_rng(seed).choice(sample, len(counts) * b)
    rows = torch.from_numpy(data.view(np.int32).reshape(-1, ge.ROW_WORDS)
                            .copy()).to(cuda)
    nb = torch.tensor(counts, dtype=torch.int32, device=cuda)
    return (rows, tk.ils_enc_tabs(table, device=cuda), nb,
            max(table.max_len_present, 1))


@pytest.mark.parametrize("kind", ["max_len=16", "lacks", "single", "uniform"])
def test_gap_byte_counts_kernels_match_plain(cuda, kind):
    # partial last rows, rows past the count and counts of 0, 1 and
    # 128k+1 inside a group of full blocks, at tile edges of B4b (128
    # rows) and B4c (up to 512 rows, 16 at seg_bits 8); B4d after them
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    ge.reset_launch_counts()
    calls = 0
    for rpb, counts in (
        (1, [128, 0, 1, 127, 65, 128]),
        (8, [1024, 0, 1, 129, 1000, 1023, 513]),
        (600, [600 * 128, 512 * 128 + 1, 512 * 128, 128 * 128 + 1, 1,
               0, 77777]),
    ):
        rows, enc, nb, max_len = _byte_count_case(cuda, kind, counts,
                                                  128 * rpb, rpb)
        cap = ge.row_cap_words(max_len)
        for c in (cap, 6):
            got = ge.gap_row_pack(rows, enc, cap_words=c, n_bytes=nb)
            assert _equal(got, ge.gap_row_pack_plain(rows, enc, cap_words=c,
                                                     n_bytes=nb)), (rpb, c)
        pay, bits = got if c == cap else ge.gap_row_pack(
            rows, enc, cap_words=cap, n_bytes=nb)
        bits_blk = bits.view(-1, rpb).to(torch.int64)
        assert not bits_blk[torch.tensor(counts) == 0].any()
        s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
        top = int(bits_blk.sum(1).max())
        for seg_bits in (8, 128, 1024):
            for n_segs in (-(-top // seg_bits) + 1,
                           max(top // seg_bits // 2, 1)):
                kw = dict(rows_per_block=rpb, n_segs=n_segs, seg_bits=seg_bits,
                          n_bytes=nb)
                assert _equal(
                    ge.gap_row_meta(rows, enc, s_local, max_len=max_len, **kw),
                    ge.gap_row_meta_plain(rows, enc, s_local, **kw)), \
                    (rpb, seg_bits, n_segs)
                calls += 1
        kw = dict(rows_per_block=rpb, out_words=top // 32 + 2)
        assert _equal(ge.gap_place_bits(pay, bits, s_local, **kw),
                      ge.gap_place_bits_plain(pay, bits, s_local, **kw))
    counts = ge.launch_counts()
    assert counts["gap_row_pack"] == 3 * 3
    assert counts["gap_row_meta"] == calls
    assert counts["gap_place_bits"] == 3


@pytest.mark.parametrize("b", [1, 127, 129, 1000, 1001, 4095])
def test_encode_blocks_any_size_on_card(cuda, b):
    # encode_blocks on the card equals its CPU run and encode_block per
    # block, from a slice at an odd byte offset (F6) and from an aligned
    # copy, with and without byte counts shorter than B
    from huffman_tpu_torch.ops import encode as tenc
    from huffman_tpu_torch.ops import gap_encode_kernels as ge

    for kind in ("uniform", "single", "max_len=16"):
        sample, table = _map_case(kind)
        g = 3
        flat = np.random.default_rng(b).choice(sample, g * b + 1)
        ml = max(table.max_len_present, 1)
        max_words = -(-(-(-b * ml // 32)) // 512) * 512
        for seg_bits in (128, 1024):
            n_segs = -(-max_words * 32 // seg_bits)
            kw = dict(seg_bits=seg_bits, max_words=max_words, n_segs=n_segs,
                      max_len=ml)
            src = torch.from_numpy(flat).to(cuda)
            for blocks in (src[1:].view(g, b), src[:-1].view(g, b).clone()):
                for counts in (None, [b, max(b // 2, 1), 1]):
                    nb = (None if counts is None else
                          torch.tensor(counts, dtype=torch.int32, device=cuda))
                    ge.reset_launch_counts()
                    got = ge.encode_blocks(
                        blocks, tk.ils_enc_tabs(table, device=cuda),
                        n_bytes=nb, **kw)
                    assert all(ge.launch_counts().values())
                    ref = ge.encode_blocks(
                        blocks.cpu(), tk.ils_enc_tabs(table, device="cpu"), **kw,
                        n_bytes=None if nb is None else nb.cpu())
                    assert _equal(tuple(x.cpu() for x in got), ref), \
                        (kind, seg_bits, counts)
                    for i in range(g):
                        n_i = b if counts is None else counts[i]
                        one = tenc.encode_block(
                            blocks[i, :n_i].cpu(),
                            tk.ils_enc_tabs(table, device="cpu"),
                            seg_bits=seg_bits, max_words=max_words,
                            n_segs=n_segs)
                        assert _equal(tuple(x[i] for x in ref), one), \
                            (kind, seg_bits, counts, i)


# ----------------------------------------------------------------------
# The byte histogram kernel (csrc/byte_histogram.cu)
# ----------------------------------------------------------------------
def _hist_data(kind, n, seed=5):
    if kind == "constant":
        return np.full(n, ord("C"), np.uint8)
    r = {"0.9": 0.9, "0.1": 0.1, "uniform": 0.0}[kind]
    return generate_redundant(n, r, seed=seed)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, (4 << 20) + 3])
@pytest.mark.parametrize("kind", ["constant", "0.9", "0.1", "uniform"])
def test_byte_counts_match_bincount(cuda, kind, n):
    from huffman_tpu_torch.ops import histogram_kernels as hk

    x = torch.from_numpy(_hist_data(kind, n)).to(cuda)
    got = hk.byte_counts(x)
    assert got.dtype == torch.int64 and got.shape == (256,)
    assert got.device == x.device
    assert torch.equal(got, torch.bincount(x, minlength=256))


@pytest.mark.parametrize("view", ["[1:]", "[3:-5]", "[::3]"])
def test_byte_counts_of_views(cuda, view):
    # unaligned heads and ragged tails of every length the slices give,
    # and a strided view (copied by the wrapper), each exact
    from huffman_tpu_torch.ops import histogram_kernels as hk

    base = torch.from_numpy(_hist_data("0.9", (1 << 20) + 77)).to(cuda)
    for off in range(17):
        x = {"[1:]": base[1 + off:], "[3:-5]": base[3 + off:-5 - off],
             "[::3]": base[off::3]}[view]
        assert torch.equal(hk.byte_counts(x),
                           torch.bincount(x.reshape(-1), minlength=256)), off
    two_d = base[: 1000 * 1000].view(1000, 1000)[:, 1:999]
    assert not two_d.is_contiguous()
    assert torch.equal(hk.byte_counts(two_d),
                       torch.bincount(two_d.reshape(-1), minlength=256))


def test_byte_counts_past_32_bits(cuda):
    # 2^32 + 7 bytes from an odd offset: one bin's count passes 2^32; the
    # counts are known by construction, exactly
    from huffman_tpu_torch.ops import histogram_kernels as hk

    n = (1 << 32) + 7
    buf = torch.full((n + 3,), ord("A"), dtype=torch.uint8, device=cuda)
    x = buf[3:]
    x[:2] = 1
    x[-2:] = 2
    x[1 << 31] = 3
    want = torch.zeros(256, dtype=torch.int64)
    want[1], want[2], want[3] = 2, 2, 1
    want[ord("A")] = n - 5
    got = hk.byte_counts(x).cpu()
    del buf, x
    assert int(got[ord("A")]) > (1 << 32)
    assert torch.equal(got, want)


def test_byte_counts_launch_once_a_call(cuda):
    from huffman_tpu_torch.core import npref
    from huffman_tpu_torch.ops import histogram as ops_histogram
    from huffman_tpu_torch.ops import histogram_kernels as hk

    x = torch.from_numpy(_hist_data("0.1", 100_001)).to(cuda)
    hk.reset_launch_counts()
    want = torch.bincount(x, minlength=256)
    assert torch.equal(hk.byte_counts(x), want)
    assert hk.launch_counts() == {"byte_counts": 1}
    assert np.array_equal(npref.histogram(x), want.cpu().numpy())
    assert hk.launch_counts() == {"byte_counts": 2}
    got = ops_histogram(x)
    assert got.dtype == torch.int32 and torch.equal(got, want.to(torch.int32))
    assert hk.launch_counts() == {"byte_counts": 3}
    with pytest.raises(TypeError, match="uint8"):
        hk.byte_counts(x.to(torch.int32))
    assert hk.launch_counts() == {"byte_counts": 3}


@pytest.mark.parametrize("r", [0.9, 0.1])
def test_ils_container_same_with_bincount(cuda, monkeypatch, r):
    # the kernel's counts give the same avg_bits, so the same tier, snum
    # and certified parameters: the containers are equal byte for byte;
    # each encode launches the kernel once a section
    from huffman_tpu_torch.ops import histogram_kernels as hk
    from huffman_tpu_torch.utils import trace

    data = generate_redundant(3 * (4 << 20) + 70_001, r, seed=11)
    x = torch.from_numpy(data).to(cuda)
    blobs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(hk, "byte_counts", hk.byte_counts_plain)
        codec = IlsCodec.fit(x)
        trace.drain()
        hk.reset_launch_counts()
        blobs.append(write_ils_container(codec.encode(x)))
        sections = trace.drain()["counters"]["ils.sections"]
        assert sections >= 2
        launched = hk.launch_counts()["byte_counts"]
        assert launched == (0 if patched else sections), (launched, sections)
    assert blobs[0] == blobs[1]
    comp = read_ils_container(blobs[0])
    assert torch.equal(IlsCodec(comp.table).decode(comp).reshape(-1), x)
