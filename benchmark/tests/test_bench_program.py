"""The readers of the program's own spans and counters (`program.py`,
the ``program_span`` and ``program_counter`` metrics): their arithmetic on
a synthetic traced context, None without one, that the program's spans
leave every number of the device trace's reduction as it was, and that a
traced run's records hold its traced stages alone.  The test marked
``cuda`` holds a span and the kernel it waits for to one clock.

    python -m pytest benchmark/tests -q
"""

import types

import pytest
import torch

from benchmark import spec as specs, trace
from benchmark.run import Run, execute
from benchmark.tests.test_bench_harness import _events, _Ev

# the program's metrics: each keeps its source and at least these cells (a
# list may gain a cell).  The ILS encode's rate is a per-layer metric, so
# its encode counts are split from the HTC1 encode's under names of their
# own, which move another end-to-end metric
NEW = {
    "host_syncs.encode": ("program_counter", ["htc1-r01.bulk"]),
    "host_syncs.ils_encode": ("program_counter", ["ils-r09.bulk"]),
    "host_syncs.decode": ("program_counter", ["ils-r09.bulk", "htc1-r01.bulk"]),
    "host_syncs.pages": ("program_counter", ["ils-r09.pages"]),
    "alloc_calls.encode": ("program_counter", ["htc1-r01.bulk"]),
    "alloc_calls.ils_encode": ("program_counter", ["ils-r09.bulk"]),
    "alloc_calls.decode": ("program_counter", ["ils-r09.bulk", "htc1-r01.bulk"]),
    "pack_passes.encode": ("program_counter", ["ils-r09.bulk"]),
    "histogram_roofline.encode": ("program_span", ["ils-r09.bulk"]),
    "crc_ms.pages": ("program_span", ["ils-r09.pages"]),
}


def program_metrics_kept(spec):
    for m in spec["per_layer"]:
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter"), m["name"]
    got = {m["name"]: (m["source"], m["workloads"]) for m in spec["per_layer"]
           if m["name"] in NEW}
    assert set(got) == set(NEW)
    for name, (source, cells) in NEW.items():
        assert got[name][0] == source and set(cells) <= set(got[name][1]), name
        assert callable(specs.metric_reader(name).read)


def test_per_layer_sources_and_the_program_metrics():
    program_metrics_kept(specs.load_spec())


def test_program_spans_leave_the_reduction_as_it_was():
    """The program's ``htt.*`` annotations, host and device side, change no
    number of `trace.summarize` that a reader or the breakdown reads."""
    plain = trace.summarize(_events(), {"ils_decode": 1}, {"ils_decode_kernel"})
    ev = _events() + [
        _Ev("htt.ils.decode", "CPU", 205, 445, user=True),
        _Ev("htt.ils.section", "CPU", 206, 300, user=True),
        _Ev("htt.sync.row_starts", "CPU", 207, 225, user=True),
        _Ev("htt.ils.section", "CUDA", 300, 400, user=True),
        _Ev("htt.io.parse", "CPU", 10, 190, user=True),
    ]
    assert trace.summarize(ev, {"ils_decode": 1}, {"ils_decode_kernel"}) == plain


def _span(sid, name, parent, call, start, end, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end, "id": sid,
            "parent": parent, "call": call, "attrs": attrs}


def _ctx(on_card=True):
    spans = [
        # two ILS encodes, one rotated re-encode; one ILS decode
        _span(1, "ils.encode", 0, 1, 0, 100, counts={
            "host_syncs.histogram": 2, "host_syncs.certify": 2,
            "host_syncs.row_starts": 2, "ils.passes": 2, "ils.sections": 2,
            "histogram_bytes": 3_350_000, "alloc_calls": 0}),
        _span(2, "ils.histogram", 1, 1, 1, 40, device_s=0.002),
        _span(3, "ils.histogram", 1, 1, 41, 50, device_s=0.0005),
        _span(4, "ils.encode", 0, 4, 100, 200, counts={
            "host_syncs.histogram": 2, "host_syncs.certify": 4,
            "host_syncs.row_starts": 4, "ils.passes": 4, "ils.sections": 2,
            "histogram_bytes": 3_350_000, "alloc_calls": 4}),
        _span(5, "ils.histogram", 4, 4, 101, 140, device_s=0.0025),
        _span(6, "ils.decode", 0, 6, 200, 300, counts={
            "host_syncs.row_starts": 2}),
        # a page read: parse (with its CRC), tables, decode
        _span(7, "io.parse", 0, 7, 300, 400, counts={}),
        _span(8, "io.crc", 7, 7, 310, 350_310),
        _span(9, "ils.tables", 0, 9, 400, 500, counts={
            "host_syncs.enc_table": 1, "host_syncs.dec_tables": 3}),
        _span(10, "ils.decode", 0, 10, 500, 600, counts={
            "host_syncs.payload": 1, "host_syncs.row_starts": 1}),
    ]
    return types.SimpleNamespace(
        stages={"pages": {"calls": 2}}, host={}, on_card=on_card,
        device_kind="NVIDIA H100 80GB HBM3", least_bytes={},
        program_spans=spans)


def test_program_readers_on_a_traced_context():
    ctx = _ctx()

    def read(name):
        return specs.metric_reader(name).read(ctx)

    assert read("host_syncs.encode") == 8.0       # (6 + 10) / 2 calls
    assert read("host_syncs.ils_encode") == 8.0
    assert read("host_syncs.decode") == 2.0       # (2 + 2) / 2
    # every call's over the stage's 2 requests: (6 + 10 + 2 + 0 + 4 + 2) / 2
    assert read("host_syncs.pages") == pytest.approx(12.0)
    assert read("alloc_calls.encode") == 2.0
    assert read("alloc_calls.ils_encode") == 2.0
    assert read("alloc_calls.decode") is None     # no decode read it
    assert read("pack_passes.encode") == 1.5      # 6 passes, 4 sections
    # 6.7e6 B at 3.35e12 B/s = 2 us over 5 ms of the spans' device time
    assert read("histogram_roofline.encode") == pytest.approx(0.04)
    assert read("crc_ms.pages") == pytest.approx(0.175)  # 0.35 ms, 2 requests


@pytest.mark.parametrize("name", sorted(NEW))
def test_program_readers_read_none_without_records(name):
    reader = specs.metric_reader(name)
    assert reader.read(_ctx(on_card=False)) is None
    ctx = _ctx()
    ctx.program_spans = None      # a program without the module
    assert reader.read(ctx) is None
    ctx.program_spans = []        # a run that recorded nothing
    assert reader.read(ctx) is None


def test_a_traced_run_records_its_traced_stages_alone():
    from huffman_tpu_torch.utils import trace as program

    program.drain()
    run = Run("ils-r09.bulk", 11, True, "cpu", overrides=specs.tiny("ils-r09.bulk"))
    out = execute(run, 0.6, 0.0)
    assert out["correct"] and out["metrics"] == {}   # off the card: none
    tops = [s["name"] for s in program.drain()["spans"] if s["parent"] == 0]
    # set-up and the check are not profiled, so not recorded
    assert tops.count("ils.encode") == run.tracer.stages["encode"]["calls"]
    assert tops.count("ils.decode") == run.tracer.stages["decode"]["calls"]
    assert set(tops) == {"ils.encode", "ils.decode"}


@pytest.mark.cuda
def test_a_program_span_holds_its_kernel_on_the_trace_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from huffman_tpu_torch.graft_entry import entry
    from huffman_tpu_torch.utils import trace as program

    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with program.span("check.a1"):
            fn(*args)
            torch.cuda.synchronize()
    program.drain()
    ev = list(prof.profiler.kineto_results.events())
    host = [e for e in ev if e.name() == "htt.check.a1"
            and not str(e.device_type()).endswith("CUDA")]
    a1 = [e for e in ev if e.name().startswith("ils_decode_kernel")]
    assert len(host) == 1 and len(a1) == 1
    s, e = host[0].start_ns(), host[0].end_ns()
    k0, k1 = a1[0].start_ns(), a1[0].start_ns() + a1[0].duration_ns()
    assert s - 10_000 <= k0 < k1 <= e + 10_000
