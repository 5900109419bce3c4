"""The port's spans and counters (`huffman_tpu_torch/utils/trace.py`) on
the CPU: off by default and then free, the span tree of each codec call,
the host syncs by site, the launch counters' dict, and the sync sites'
routing through the two helpers.  Tiny shapes: 2 tiles of k=32 plus a
tail (the fused tier, then the two-pass tier on the tail), 2 tiles of
k=16, 2 HTC1 blocks of 4 KiB.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from huffman_tpu_torch import GapArrayCodec, IlsCodec
from huffman_tpu_torch.io import read_ils_container, write_ils_container
from huffman_tpu_torch.ops import cuda_build
from huffman_tpu_torch.ops import (
    encode_map_kernels as em,
    gap_decode_kernels as gd,
    gap_encode_kernels as ge,
    histogram_kernels as hk,
    ils_kernels as tk,
    selfsync_kernels as sk,
)
from huffman_tpu_torch.ops.launch import launch
from huffman_tpu_torch.utils import generate_redundant, trace

PORT = Path(__file__).resolve().parents[1] / "huffman_tpu_torch"


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _ils(k=32, tail=5000, seed=3):
    d = generate_redundant(2 * k * 1024 + tail, 0.5, seed=seed)
    return d, IlsCodec.fit(d, k=k, device="cpu")


def _gap():
    d = generate_redundant(2 * 4096, 0.1, seed=5).reshape(2, 4096)
    return d, GapArrayCodec.fit(d, block_bytes=4096, device="cpu")


def _tree(spans):
    """Each call as nested (name, [children]) in the order spans opened."""
    kids = {}
    for s in sorted(spans, key=lambda s: (s["start_ns"], s["id"])):
        kids.setdefault(s["parent"], []).append(s)

    def node(s):
        return (s["name"], [node(c) for c in kids.get(s["id"], [])])

    return [node(s) for s in kids.get(0, [])]


def _syncs(top):
    return {k[len("host_syncs."):]: v for k, v in top["attrs"]["counts"].items()
            if k.startswith("host_syncs.")}


S = "sync."
FUSED = [("ils.histogram", [(S + "histogram", [])]),
         ("ils.pass", [(S + "certify", [])]),
         ("ils.compact", [(S + "row_starts", [])])]
TWO_PASS = [("ils.histogram", [(S + "histogram", [])]),
            ("ils.pass", [(S + n, []) for n in
                          ("lane_min", "lane_max", "envelope", "row_starts",
                           "boffs")])]


def test_off_records_nothing_and_returns_the_shared_null_context():
    assert trace.span("a") is trace.span("b", k=1)
    d, c = _ils()
    c.decode(c.encode(torch.from_numpy(d)))
    got = trace.drain()
    assert got["spans"] == []
    # the counters are always on
    assert got["counters"]["host_syncs.histogram"] == 2


def test_ils_encode_and_decode_span_trees():
    d, c = _ils()
    trace.enable()
    comp = c.encode(torch.from_numpy(d))
    out = c.decode(comp)
    assert np.array_equal(out.numpy(), d)
    spans = trace.drain()["spans"]
    assert _tree(spans) == [
        ("ils.encode", [("ils.section", FUSED), ("ils.section", TWO_PASS)]),
        ("ils.decode", [("ils.section", [(S + "row_starts", [])]),
                        ("ils.section", [(S + "row_starts", [])]),
                        ("ils.concat", [])]),
    ]
    tops = [s for s in spans if s["parent"] == 0]
    # one call id per top-level call, shared by all its spans
    assert {s["call"] for s in spans} == {t["id"] for t in tops}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    sec = [s["attrs"] for s in spans if s["name"] == "ils.section"]
    assert sec[:2] == [{"k": 32, "n_tiles": 2}, {"k": 8, "n_tiles": 1}]
    passes = [s["attrs"] for s in spans if s["name"] == "ils.pass"]
    assert passes == [{"tier": "fused", "anchor": "mu", "rot": False},
                      {"tier": "two_pass", "anchor": None, "rot": False}]
    enc = tops[0]["attrs"]["counts"]
    assert enc["ils.sections"] == 2 and enc["ils.passes"] == 2
    assert enc["histogram_bytes"] == d.size - 5000 + 8 * 1024


def test_gap_device_span_trees():
    d, c = _gap()
    trace.enable()
    out = c.decode_device(c.encode_device(torch.from_numpy(d)))
    assert np.array_equal(out.numpy(), d)
    assert _tree(trace.drain()["spans"]) == [
        ("gap.encode", [("gap.blocks", [])]),
        ("gap.decode", [("gap.plan", [(S + "plan", [])]), ("gap.group", [])]),
    ]


def test_page_read_span_tree():
    d, c = _ils(k=16, tail=0)
    blob = write_ils_container(c.encode(torch.from_numpy(d)))
    trace.enable()
    comp = read_ils_container(blob)
    codec = IlsCodec(comp.table, device="cpu")
    assert np.array_equal(codec.decode(comp).numpy(), d)
    spans = trace.drain()["spans"]
    assert _tree(spans) == [
        ("io.parse", [("io.crc", [])]),
        ("ils.tables", [("ils.enc_tables", [(S + "enc_table", [])]),
                        ("ils.dec_tables", [(S + "dec_tables", [])] * 3)]),
        ("ils.decode", [("ils.section", [(S + "row_starts", [])]),
                        ("ils.concat", [])]),
    ]
    assert len({s["call"] for s in spans}) == 3


def _ils_calls():
    d, c = _ils()
    comp = c.encode(torch.from_numpy(d))
    return (lambda: c.encode(torch.from_numpy(d))), (lambda: c.decode(comp))


def _gap_calls():
    d, c = _gap()
    dcomp = c.encode_device(torch.from_numpy(d))
    return (lambda: c.encode_device(torch.from_numpy(d))), \
        (lambda: c.decode_device(dcomp))


def _page_read():
    d, c = _ils(k=16, tail=0)
    blob = write_ils_container(c.encode(torch.from_numpy(d)))

    def read():
        comp = read_ils_container(blob)
        IlsCodec(comp.table, device="cpu").decode(comp)
    return read


CASES = {
    "ils_encode": (lambda: _ils_calls()[0],
                   [{"histogram": 2, "certify": 1, "row_starts": 2,
                     "lane_min": 1, "lane_max": 1, "envelope": 1,
                     "boffs": 1}]),
    "ils_decode": (lambda: _ils_calls()[1], [{"row_starts": 2}]),
    "gap_encode": (lambda: _gap_calls()[0], [{}]),
    "gap_decode": (lambda: _gap_calls()[1], [{"plan": 1}]),
    "page": (_page_read, [{}, {"enc_table": 1, "dec_tables": 3},
                          {"row_starts": 1}]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_syncs_by_site(case):
    """The hand counts: an ILS encode syncs for each section's histogram,
    its certification (fused, the main section) or its envelopes
    (two-pass, the tail) and its row starts; a decode for each section's
    row starts; the HTC1 device encode never, its decode once for the
    plan; a page read (parse, tables, decode) for the encode table, the
    three decode tables and the row starts, and on a card for the
    payload's copy, which on the CPU is already where the decode runs."""
    make, want = CASES[case]
    call = make()
    trace.enable()
    call()
    tops = [s for s in trace.drain()["spans"] if s["parent"] == 0]
    assert [_syncs(t) for t in tops] == want


def test_sync_helpers_count_what_crosses():
    a = np.arange(4, dtype=np.int32)
    t = trace.to_device(a, torch.device("cpu"), "x")
    assert t.dtype == torch.int32 and t.tolist() == [0, 1, 2, 3]
    # a tensor already where it goes copies nothing and is not counted
    assert trace.to_device(t, "cpu", "x") is t
    m = trace.to_device(t, torch.device("meta"), "x")
    assert m.device.type == "meta"
    assert trace.to_host(t, "y") is t
    assert trace.drain()["counters"] == {"host_syncs.x": 2, "host_syncs.y": 1}


WRAPPERS = {
    tk: ("ils_decode", "ils_pack_certify", "ils_compact", "ils_lengths_pass",
         "ils_pack", "ils_pack_certify_stream"),
    gd: ("gap_decode_ranks", "gap_place_bytes", "gap_decode_bytes",
         "count_segments"),
    ge: ("gap_row_pack", "gap_row_meta", "gap_place_bits"),
    em: ("encode_map",),
    sk: ("sync_transitions",),
    hk: ("byte_counts",),
}


def count_launch(rc, stream):
    """A stub C entry: returns the code it is given."""
    return rc


@pytest.mark.parametrize("mod", list(WRAPPERS), ids=lambda m: m.__name__)
def test_launch_counts_keep_their_dict(mod, monkeypatch):
    names = WRAPPERS[mod]
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(names, 0)
    wrapper = getattr(mod, names[0])
    # the seam's counts, through a stub library (no nvcc)
    monkeypatch.setattr(cuda_build, "signatures", lambda: {
        "count_stub": {"count_launch": [ctypes.c_int, ctypes.c_void_p]}})
    monkeypatch.setattr(cuda_build, "load_kernels", lambda: {
        "count_stub": types.SimpleNamespace(count_launch=count_launch)})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device:
                        types.SimpleNamespace(cuda_stream=0))
    for rc in (0, 0):
        launch("count_stub", "count_launch", rc, like=torch.empty(0),
               counted=wrapper)
    with pytest.raises(RuntimeError):
        # a refused launch is not counted
        launch("count_stub", "count_launch", 2, like=torch.empty(0),
               counted=wrapper)
    assert mod.launch_counts()[names[0]] == 2
    # a drain leaves them; only their module's reset clears them, and
    # only its own wrappers'
    trace.drain()
    assert mod.launch_counts()[names[0]] == 2
    other = next(m for m in WRAPPERS if m is not mod)
    other.reset_launch_counts()
    assert mod.launch_counts()[names[0]] == 2
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(names, 0)


def test_cpu_calls_launch_nothing():
    for mod in WRAPPERS:
        mod.reset_launch_counts()
    d, c = _ils()
    c.decode(c.encode(torch.from_numpy(d)))
    for mod, names in WRAPPERS.items():
        assert mod.launch_counts() == dict.fromkeys(names, 0)


SYNC_CALL = re.compile(
    r"\.cpu\(\)|\.tolist\(\)|\.item\(\)|"
    r"from_numpy\((?:[^()]|\([^()]*\))*\)\s*\.to\(")


@pytest.mark.parametrize("path,func", [
    ("models/ils_codec.py", None), ("models/gap_codec.py", None),
    ("ops/ils.py", None), ("core/npref.py", "histogram")])
def test_sync_sites_go_through_the_helpers(path, func):
    src = (PORT / path).read_text()
    if func:
        src = re.search(rf"^def {func}\(.*?(?=^def |\Z)", src,
                        re.S | re.M).group(0)
    assert "trace.to_" in src
    assert not SYNC_CALL.findall(src), path


def test_tracing_changes_no_container_byte():
    d, c = _ils()
    off = write_ils_container(c.encode(torch.from_numpy(d)))
    trace.enable()
    on = write_ils_container(c.encode(torch.from_numpy(d)))
    assert on == off


def test_a_recording_profiler_turns_the_spans_on():
    from torch.profiler import ProfilerActivity, profile

    d, c = _ils(k=16, tail=0)
    comp = c.encode(torch.from_numpy(d))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.decode(comp)
    names = {e.name for e in prof.events()}
    assert {"htt.ils.decode", "htt.ils.section", "htt.sync.row_starts",
            "htt.ils.concat"} <= names
    assert [s["name"] for s in trace.drain()["spans"]
            if s["parent"] == 0] == ["ils.decode"]
    c.decode(comp)  # the profiler has stopped: off again
    assert trace.drain()["spans"] == []
