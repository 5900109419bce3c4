"""Call forms of the port's public functions against the JAX package's.

A call written for the JAX package means the same in the port: the same
positional slots and keyword names, with the port's ``device`` keyword-only
and last.  Each function is called in the JAX package's form in both
packages, on the same seeded NumPy input, and the results compared exactly
(integers only).  The table builders (the two exported ones and the ILS
kernels' `ils_enc_tabs` / `ils_dec_tabs`) put their tables on the card
unless the caller asks for the CPU, as every entry point does.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.core import canonical_code_table as jcct
from huffman_tpu.core import npref as jnpref
from huffman_tpu.core import package_merge_lengths as jpml
from huffman_tpu.io import read_ils_container as jread_ils
from huffman_tpu.io import seqfmt as jseq
from huffman_tpu.io import yamamoto as jyam
from huffman_tpu.ops import device_dec_table as jdevice_dec_table
from huffman_tpu.ops import device_enc_table as jdevice_enc_table
from huffman_tpu.ops import encode as jenc
from huffman_tpu.ops import ils as jils
from huffman_tpu.ops.pallas import ils_kernels as jk
from huffman_tpu.ops.pallas.ils_kernels import ils_enc_tabs as jils_enc_tabs
from huffman_tpu.utils import generate_redundant
from huffman_tpu_torch import IlsCodec, write_ils_container
from huffman_tpu_torch import ops as tops
from huffman_tpu_torch.core import canonical_code_table
from huffman_tpu_torch.io import seqfmt as tseq
from huffman_tpu_torch.io import yamamoto as tyam
from huffman_tpu_torch.ops import encode as tenc
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk

FUNCTIONS = [
    # (JAX function, port function, JAX parameters the port leaves out)
    (jdevice_dec_table, tops.device_dec_table, ()),
    (jdevice_enc_table, tops.device_enc_table, ()),
    (jyam.decode_yamamoto, tyam.decode_yamamoto, ()),
    # interpret= runs Pallas in interpret mode, a TPU matter
    (jenc.encode_block_fast, tenc.encode_block_fast, ("interpret",)),
    (jk.ils_enc_tabs, tk.ils_enc_tabs, ()),
    (jk.ils_dec_tabs, tk.ils_dec_tabs, ()),
    (jils.ils_decode_device, tils.ils_decode_device, ("interpret",)),
]


def _tables(data):
    jt = jcct(jpml(jnpref.histogram(data), 16), 16)
    return jt, canonical_code_table(jt.lengths, 16)


@pytest.mark.parametrize("jfn,pfn,left_out", FUNCTIONS,
                         ids=[f[1].__name__ for f in FUNCTIONS])
def test_parameters_match_jax(jfn, pfn, left_out):
    # the JAX parameters in the JAX order and kinds, then device
    # (keyword-only, CUDA by default)
    jps = [(p.name, p.kind, p.default)
           for p in inspect.signature(jfn).parameters.values()
           if p.name not in left_out]
    pps = list(inspect.signature(pfn).parameters.values())
    assert [(p.name, p.kind, p.default) for p in pps[:len(jps)]] == jps
    rest = pps[len(jps):]
    if pfn is tenc.encode_block_fast:
        assert not rest
    else:
        assert [(p.name, p.kind, p.default) for p in rest] == [
            ("device", inspect.Parameter.KEYWORD_ONLY, "cuda")]


def test_device_dec_table_positional_lut_bits():
    # device_dec_table(t, 11): lut_bits=11 in both packages
    data = generate_redundant(20000, 0.5, seed=4)
    jt, pt = _tables(data)
    assert pt.max_len_present != 11
    for two_level in (True, False):
        jd = jdevice_dec_table(jt, 11, two_level=two_level)
        pd = tops.device_dec_table(pt, 11, two_level=two_level, device="cpu")
        assert pd.lut_sym.numel() == 1 << 11
        for f in jd._fields:
            assert np.array_equal(getattr(pd, f).numpy(),
                                  np.asarray(getattr(jd, f))), (two_level, f)
    # the default lut_bits, positional table only
    jd, pd = jdevice_dec_table(jt), tops.device_dec_table(pt, device="cpu")
    assert pd.lut_sym.numel() == np.asarray(jd.lut_sym).size \
        == 1 << pt.max_len_present


def test_device_enc_table_holds_the_jax_pair():
    data = generate_redundant(20000, 0.9, seed=5)
    jt, pt = _tables(data)
    je = jdevice_enc_table(jt)
    pe = tops.device_enc_table(pt, device="cpu")
    assert pe.dtype == torch.int32 and pe.shape == (256,)
    assert np.array_equal(pe.numpy() >> 20, np.asarray(je.lengths))
    assert np.array_equal(pe.numpy() & 0xFFFF, np.asarray(je.codes))


@pytest.mark.parametrize("method", ["lut", "canonical"])
def test_decode_yamamoto_positional_method(method):
    data = generate_redundant(6000, 0.5, seed=6)
    _, pt = _tables(data)
    blob = tyam.write_yamamoto(data, pt)
    got = tyam.decode_yamamoto(blob, method, device="cpu")
    assert np.array_equal(got.numpy(), jyam.decode_yamamoto(blob, method))
    assert np.array_equal(got.numpy(), data)


def test_encode_block_fast_enc_tabs_keyword():
    data = generate_redundant(2 * 4096, 0.5, seed=7)
    jt, pt = _tables(data)
    total = int(pt.lengths.astype(np.int64)[data].sum())
    kw = dict(seg_bits=1024, max_words=-(-total // 32) + 3,
              n_segs=-(-total // 1024) + 1)
    ref = jenc.encode_block_fast(jnp.asarray(data), enc_tabs=jils_enc_tabs(jt),
                                 interpret=True, **kw)
    got = tenc.encode_block_fast(torch.from_numpy(data),
                                 enc_tabs=tops.device_enc_table(pt, device="cpu"),
                                 **kw)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(ref[0]))
    for a, r in zip(got[1:], ref[1:]):
        assert np.array_equal(a.numpy(), np.asarray(r))


def test_ils_table_builders_hold_the_jax_tables():
    data = generate_redundant(20000, 0.5, seed=9)
    jt, pt = _tables(data)
    je, pe = jk.ils_enc_tabs(jt), tk.ils_enc_tabs(pt, device="cpu")
    assert pe.dtype == torch.int32 and pe.shape == (256,)
    assert np.array_equal(pe.numpy(), np.concatenate(
        [np.asarray(je.lo)[0], np.asarray(je.hi)[0]]))
    jd, pd = jk.ils_dec_tabs(jt), tk.ils_dec_tabs(pt, device="cpu")
    assert np.array_equal(pd.lim.numpy().view(np.uint32), np.asarray(jd.lim)[0])
    assert np.array_equal(pd.bias.numpy(), np.asarray(jd.bias)[0, :32])
    assert np.array_equal(pd.symtab.numpy(), np.concatenate(
        [np.asarray(jd.sym_lo)[0], np.asarray(jd.sym_hi)[0]]))


def test_decode_seq_bool_device():
    # decode_seq(blob, device=False): the host walk, the JAX bytes on the
    # CPU; device=True asks for the card's self-synchronising decoder
    data = generate_redundant(3000, 0.5, seed=10)
    _, pt = _tables(data)
    blob = tseq.write_seq(data, pt)
    got = tseq.decode_seq(blob, device=False)
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), jseq.decode_seq(blob, device=False))
    assert np.array_equal(got.numpy(), data)
    if torch.cuda.is_available():
        got = tseq.decode_seq(blob, device=True)
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), data)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tseq.decode_seq(blob, device=True)


def test_ils_decode_device_probe_keyword():
    # probe= picks a TPU symbol step in the JAX package; the port accepts
    # it and gives the same bytes (k=12, 2 tiles: the JAX suite's shape)
    k = 12
    data = generate_redundant(2 * k * 1024, 0.5, seed=11)
    codec = IlsCodec.fit(data, k=k, device="cpu")
    psec = codec.encode(data).sections[0]
    jcomp = jread_ils(write_ils_container(codec.encode(data)))
    jsec = jcomp.sections[0]
    ref = np.asarray(jils.ils_decode_device(
        jsec, jcomp.table, jk.ils_dec_tabs(jcomp.table), probe=False,
        interpret=True))
    for probe in (False, True, None):
        got = tils.ils_decode_device(psec, codec.table, codec.dec, probe=probe,
                                     device="cpu")
        assert np.array_equal(got.numpy(), ref), probe
    assert np.array_equal(ref, data)


def test_table_builders_default_to_the_card():
    _, pt = _tables(generate_redundant(4000, 0.5, seed=8))
    if torch.cuda.is_available():
        assert tops.device_enc_table(pt).device.type == "cuda"
        assert tops.device_dec_table(pt).lim_left.device.type == "cuda"
        assert tk.ils_enc_tabs(pt).device.type == "cuda"
        assert tk.ils_dec_tabs(pt).lim.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.device_enc_table(pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.device_dec_table(pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.device_dec_table(pt, 11, two_level=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.ils_enc_tabs(pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.ils_dec_tabs(pt)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.device_enc_table(pt, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.ils_dec_tabs(pt, device="meta")
