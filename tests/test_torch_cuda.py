"""CUDA kernels of huffman_tpu_torch against their plain PyTorch versions.

Needs a card: every test is marked `cuda` and skips without one.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` skips `tests/conftest.py`, which imports JAX.)

Every comparison is of integers and exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from huffman_tpu_torch import IlsCodec
from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_schedule_numer
from huffman_tpu_torch.io import read_ils_container, write_ils_container
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk
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
