"""The port's flagship entry point (`huffman_tpu_torch/graft_entry.py`)
against the JAX package's `__graft_entry__.py`.

`entry(device="cpu")` gives the JAX `entry()`'s example arguments and its
decode step's words exactly: the same section (k=256, 4 tiles of
`generate_redundant(r=0.5, seed=0)`), with A1's plain version on the CPU.
The JAX step runs its Pallas kernel in interpret mode, once per module.
"""

import runpy
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from huffman_tpu_torch import IlsCodec, graft_entry
from huffman_tpu_torch.ops import ils_kernels as tk
from huffman_tpu_torch.parallel import dryrun as tdr
from huffman_tpu_torch.utils import generate_redundant

ARG_NAMES = ("payload_rows", "row_starts", "params")


@pytest.fixture(scope="module")
def jax_step():
    fn, args = jentry.entry()
    return [np.asarray(a) for a in args], np.asarray(fn(*args))


@pytest.fixture(scope="module")
def port_step():
    fn, args = graft_entry.entry(device="cpu")
    return fn, args


@pytest.mark.parametrize("i", range(len(ARG_NAMES)), ids=ARG_NAMES)
def test_example_args_match_jax(jax_step, port_step, i):
    jargs, _ = jax_step
    _, args = port_step
    assert args[i].dtype == torch.int32 and args[i].device.type == "cpu"
    assert np.asarray(jargs[i]).dtype == np.int32
    assert np.array_equal(args[i].numpy().reshape(-1), jargs[i].reshape(-1))


def test_payload_rows_end_in_w_cap_zero_rows(port_step):
    _, (payload_rows, row_starts, params) = port_step
    data = generate_redundant(4 * 256 * 1024, 0.5, seed=0)
    p = IlsCodec.fit(data, k=256, device="cpu").encode(data).sections[0].params
    assert p.n_tiles == 4 and p.k == 256
    assert payload_rows.shape == (p.total_rows + p.w_cap, 1024)
    assert not payload_rows[p.total_rows:].any()
    assert row_starts.tolist() == p.row_starts[:-1].tolist()
    assert params.tolist() == [p.snum, 0]


def test_fn_output_matches_jax_and_the_data(jax_step, port_step):
    _, jout = jax_step
    fn, args = port_step
    tk.reset_launch_counts()
    out = fn(*args)
    # the plain version on the CPU: no launch counted
    assert tk.launch_counts()["ils_decode"] == 0
    assert out.dtype == torch.int32 and out.shape == (256, 1024)
    assert np.array_equal(out.numpy().reshape(-1), jout.reshape(-1))
    data = generate_redundant(4 * 256 * 1024, 0.5, seed=0)
    assert np.array_equal(out.numpy().view(np.uint8).reshape(-1), data)


def test_fn_does_not_read_params(port_step):
    # A1 takes lengths from its table: snum never reaches it
    fn, (payload_rows, row_starts, params) = port_step
    ref = fn(payload_rows, row_starts, params)
    assert torch.equal(fn(payload_rows, row_starts, torch.zeros_like(params)),
                       ref)


def test_entry_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        fn, args = graft_entry.entry()
        assert all(a.device.type == "cuda" for a in args)
        tk.reset_launch_counts()
        fn(*args)
        assert tk.launch_counts()["ils_decode"] == 1
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(ValueError, match="unsupported device"):
        graft_entry.entry(device="meta")


def test_dryrun_multichip_is_the_parallel_one():
    assert graft_entry.dryrun_multichip is tdr.dryrun_multichip
    assert set(graft_entry.__all__) == {"entry", "dryrun_multichip"}


@pytest.mark.parametrize("argv,expect", [
    ([], (8, "nccl", "cuda", None)),
    (["3", "--backend", "gloo", "--device", "cpu", "--out-dir", "d"],
     (3, "gloo", "cpu", "d")),
])
def test_module_main_runs_the_dry_run(monkeypatch, argv, expect):
    # `python -m huffman_tpu_torch.graft_entry [N]`, as
    # `python __graft_entry__.py N`: N ranks, 8 by default
    calls = []
    monkeypatch.setattr(tdr, "dryrun_multichip", lambda n, **kw: calls.append(
        (n, kw["backend"], kw["device"], kw["out_dir"])))
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(sys, "argv", ["graft_entry", *argv])
    # run as `-m` runs it: a fresh module named __main__
    monkeypatch.delitem(sys.modules, "huffman_tpu_torch.graft_entry")
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("huffman_tpu_torch.graft_entry", run_name="__main__")
    assert exc.value.code == 0
    assert calls == [expect]
