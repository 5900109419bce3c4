"""The port's differential fuzz soak (`tools/fuzz_torch.py`) on the CPU.

(a) The tool's own cases on ``device="cpu"`` (seed 0, inputs of at most 64
KiB), each held by the tool to the data and to the NumPy oracles.  (b)
Inputs from the tool's generator through both packages: ILS containers,
HTC1 containers (``method="lut"``) and the Yamamoto and sequential.cpp
blobs equal the JAX package's, at the JAX suite's small shapes (k of 8
and 12, one or two tiles, max_len 12 and 16: four interpret-mode
shapes).  (c) A fault planted in a plain version fails the tool's case
with its reproducer line, so the soak can fail.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from huffman_tpu.io import write_container as jwrite_container
from huffman_tpu.io import write_ils_container as jwrite_ils
from huffman_tpu.io import seqfmt as jseq
from huffman_tpu.io import yamamoto as jyam
from huffman_tpu.models import GapArrayCodec as JGapArrayCodec
from huffman_tpu.models import IlsCodec as JIlsCodec
from huffman_tpu_torch import (
    GapArrayCodec,
    IlsCodec,
    write_container,
    write_ils_container,
    write_seq,
    write_yamamoto,
)
from huffman_tpu_torch.ops import gap_encode_kernels as ge
from huffman_tpu_torch.ops import ils_kernels as tk

_SPEC = importlib.util.spec_from_file_location(
    "fuzz_torch",
    pathlib.Path(__file__).resolve().parent.parent / "tools" / "fuzz_torch.py")
fuzz = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(fuzz)

SMALL = 64 << 10
# (a): cases 0-11 of seed 0 hold the ILS leg and, every fourth case, the
# secondary leg's first three kinds (gap, gapdev, encode_block_fast)
CASES = range(12)


@pytest.mark.parametrize("i", CASES)
def test_fuzz_case_on_cpu(i):
    leg, p = fuzz.run_case(0, i, torch.device("cpu"), max_bytes=SMALL)
    assert p["n"] <= SMALL
    assert leg == ("ils" if i % 4 != 3 else fuzz.SECONDARY[i // 4])


def test_fuzz_secondary_kinds_on_cpu():
    # the other two secondary kinds, on the same seed
    for which in ("selfsync", "yamamoto"):
        rng = np.random.default_rng([0, 100])
        leg, p = fuzz.secondary_case(100, rng, "cpu", which=which,
                                     max_bytes=SMALL)
        assert leg == which and p["n"] <= SMALL


# (k, tiles, max_len, kind, rot): four JAX shapes
CROSS = [(8, 1, 12, "zipf", False), (8, 2, 16, "blocky", True),
         (12, 1, 16, "uniform", "auto"), (12, 2, 12, "two", False)]


@pytest.mark.parametrize("k,tiles,max_len,kind,rot", CROSS)
def test_fuzz_inputs_match_jax(k, tiles, max_len, kind, rot):
    rng = np.random.default_rng([1, k, tiles])
    data = fuzz.gen_data(rng, kind, tiles * k * 1024)
    jc = JIlsCodec.fit(data, k=k, max_len=max_len, rotate=rot,
                       interpret=True)
    pc = IlsCodec.fit(data, k=k, max_len=max_len, rotate=rot, device="cpu")
    assert write_ils_container(pc.encode(data)) == jwrite_ils(jc.encode(data))
    # HTC1 at blocks of 1000 bytes and a ragged tail (the JAX package's
    # encode_block route), decoded by the flat LUT
    jg = JGapArrayCodec.fit(data, max_len=max_len, block_bytes=1000,
                            method="lut")
    pg = GapArrayCodec.fit(data, max_len=max_len, block_bytes=1000,
                           method="lut", device="cpu")
    assert write_container(pg.encode(data)) == jwrite_container(jg.encode(data))
    assert write_yamamoto(data, pc.table) == jyam.write_yamamoto(data, jc.table)
    assert write_seq(data, pc.table) == jseq.write_seq(data, jc.table)


def _flip_first(fn):
    def planted(*args, **kw):
        out = fn(*args, **kw)
        out = out.clone() if isinstance(out, torch.Tensor) else out
        out.view(-1)[0] ^= 1
        return out
    return planted


@pytest.mark.parametrize("module,name,i", [
    (tk, "ils_decode_plain", 0),  # A1: ILS case 0
    (ge, "gap_place_bits_plain", 3),  # B4d: the HTC1 case 3
])
def test_planted_fault_fails_the_case(monkeypatch, module, name, i):
    monkeypatch.setattr(module, name, _flip_first(getattr(module, name)))
    with pytest.raises(fuzz.FuzzFailure,
                       match=rf"^fuzz FAIL seed=0 iter={i} leg=\w+ kind="):
        fuzz.run_case(0, i, torch.device("cpu"), max_bytes=SMALL)
