"""The benchmark's harness on the CPU: discovery, seeded inputs, the
arithmetic of its metrics, the result line, the reference, the import
guard.  No card, nvcc or triton is needed, apart from the one test marked
``cuda``, which runs a short cell on the card and skips elsewhere.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import datagen, readings, spec as specs, trace, traffic
from benchmark.reference import htc1 as ref_htc1, huffman, ils as ref_ils
from benchmark.run import Run, execute

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# cells at a size the CPU holds in a test; the codec's plain path runs
TINY = {
    "ils-r09.bulk": {"config": {"n_bytes": 300_000, "k": 64},
                     "mix": {"inputs": 3}},
    "htc1-r01.bulk": {"config": {"n_bytes": 4 * 16384, "block_bytes": 16384},
                      "mix": {"inputs": 3}},
    "ils-r09.pages": {"config": {"k": 64},
                      "mix": {"pool": 8, "min_bytes": 4096, "max_bytes": 65536}},
}


def tiny_run(workload, seed=7, traced=False, patch=None, seconds=0.3):
    run = Run(workload, seed, traced, "cpu", overrides=TINY[workload],
              patch=patch)
    return execute(run, seconds, 0.0)


@pytest.fixture(scope="module")
def spec():
    return specs.load_spec()


# ----------------------------------------------------------------------
# discovery and the file's shape
# ----------------------------------------------------------------------
def test_every_cell_finds_its_parts(spec):
    assert set(TINY) == {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        cfg = specs.config(spec, w["config"])
        mix = specs.mix(w["traffic"])
        loop = specs.loop(mix["loop"])
        for fn in ("setup", "window", "check"):
            assert callable(getattr(loop, fn))
        driver = specs.driver(cfg["driver"])
        needs = {"bulk": ("input_shape", "encode", "decode", "container"),
                 "pages": ("pack", "read")}[mix["loop"]]
        for fn in ("fit", "fit_from_freqs") + needs:
            assert callable(getattr(driver, fn))
        assert callable(specs.reference(cfg["reference"]).check)
        e2e = {m["name"] for m in specs.end_to_end(spec, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = specs.per_layer(spec, w["name"])
        assert layer
        for m in layer:
            assert callable(specs.metric_reader(m["name"]).read)
            assert m["moves"] in e2e


def test_benchmark_json_keeps_to_its_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["source"].startswith("https://")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in spec["per_layer"]}
    assert layers <= {"kernels", "device", "orchestration", "io", "tables"}


# ----------------------------------------------------------------------
# seeded inputs
# ----------------------------------------------------------------------
def test_seeded_data_repeats():
    seed = 2**31 + 12345
    a = datagen.redundant(50_000, 0.9, seed, traffic.DATA, "cpu")
    b = datagen.redundant(50_000, 0.9, seed, traffic.DATA, "cpu")
    c = datagen.redundant(50_000, 0.9, seed + 1, traffic.DATA, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    share = float(((a >= 65) & (a <= 68)).float().mean())
    assert 0.88 < share < 0.93  # 0.9, plus 4/256 of the uniform tenth


def test_page_pool_is_one_set_of_sizes_in_a_seeded_order():
    sizes = datagen.log_uniform_sizes(256, 8192, 1 << 20)
    assert sizes.min() >= 8192 and sizes.max() <= 1 << 20
    assert 200_000 < sizes.mean() < 230_000
    pools = []
    for seed in (1, 1, 2):
        run = types.SimpleNamespace(
            config={"redundancy": 0.9, "max_len": 16, "k": 64,
                    "optimize": "speed", "rotate": "auto"},
            mix={"pool": 6, "min_bytes": 4096, "max_bytes": 40000},
            seed=seed, device=torch.device("cpu"),
            codec=specs.driver("ils"),
            tracer=trace.Tracer(False, "cpu"))
        pools.append(specs.loop("pages").setup(run))
    same = [torch.equal(x, y) for x, y in zip(pools[0]["pages"], pools[1]["pages"])]
    assert all(same) and pools[0]["blobs"] == pools[1]["blobs"]
    assert (sorted(p.numel() for p in pools[0]["pages"])
            == sorted(p.numel() for p in pools[2]["pages"]))


# ----------------------------------------------------------------------
# the arithmetic of the metrics
# ----------------------------------------------------------------------
def test_p95_is_nearest_rank_over_all_requests():
    assert traffic.p95(range(1, 101)) == 95
    assert traffic.p95([5.0]) == 5.0
    assert traffic.p95([1, 2, 3, 4, 100]) == 100
    assert traffic.p95(list(range(1, 21))) == 19


class _Ev:
    def __init__(self, name, dev, start, end, corr=0, user=False):
        self._n, self._d, self._s, self._e, self._c, self._u = (
            name, dev, start, end, corr, user)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def is_user_annotation(self):
        return self._u

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c


def _events(lose_one=False):
    ev = [
        _Ev("bench.stage", "CPU", 0, 1000, user=True),
        _Ev("bench.request", "CPU", 0, 500, user=True),
        _Ev("bench.parse", "CPU", 0, 200, user=True),
        _Ev("bench.decode", "CPU", 200, 450, user=True),
        _Ev("cudaLaunchKernel", "CPU", 210, 220, corr=1),
        _Ev("cudaLaunchKernel", "CPU", 230, 240, corr=2),
        _Ev("ils_decode_kernel(unsigned int const*)", "CUDA", 300, 400, corr=1),
        _Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 350, 450, corr=2),
        _Ev("bench.decode", "CUDA", 300, 450, user=True),  # a GPU annotation
        _Ev("void at::native::fill", "CUDA", 700, 800, corr=3),
        _Ev("cudaLaunchKernel", "CPU", 690, 695, corr=3),
    ]
    if lose_one:
        ev.insert(5, _Ev("cudaLaunchKernel", "CPU", 240, 245, corr=9))
    return ev


def test_trace_reduction_busy_idle_gaps_and_launch_check():
    s = trace.summarize(_events(), {"ils_decode": 1}, {"ils_decode_kernel"})
    assert s["window_s"] == 1000e-9
    assert s["busy_s"] == pytest.approx(250e-9)   # [300, 450) and [700, 800)
    assert s["op_s"] == pytest.approx(300e-9)     # summed, overlap counted twice
    assert s["n_ops"] == 3
    # each gap goes to the innermost span at its middle: [0, 300) to
    # parse, [450, 700) and [800, 1000) to the loop outside any request
    assert s["idle_by_span"] == pytest.approx({"parse": 300e-9, "loop": 450e-9})
    # the longest gaps one by one: (span, seconds, start in the stage)
    assert s["longest_gaps"] == pytest.approx(
        [("parse", 300e-9, 0.0), ("loop", 250e-9, 450e-9), ("loop", 200e-9, 800e-9)])
    assert s["port_kernels"] == 1 and s["launches_ok"]
    lost = trace.summarize(_events(lose_one=True), {"ils_decode": 1},
                           {"ils_decode_kernel"})
    assert lost["lost_launches"] == 1 and not lost["launches_ok"]
    short = trace.summarize(_events(), {"ils_decode": 2}, {"ils_decode_kernel"})
    assert not short["launches_ok"]
    assert s["missing_kernels"] == 0 and s["imputed_s"] == 0
    # one lost launch in LOST_SHARE is borne, and charged at the longest
    # mean time of a library op; what ran before the stage's span (the
    # settling launch) is not the stage's
    ev = _events() + [_Ev("cudaLaunchKernel", "CPU", 500, 501, corr=100 + i)
                      for i in range(trace.LOST_SHARE)]
    ev += [_Ev("void fill", "CUDA", 900, 901, corr=100 + i)
           for i in range(trace.LOST_SHARE - 1)]
    ev += [_Ev("cudaLaunchKernel", "CPU", -50, -40, corr=7),
           _Ev("void settle", "CUDA", -30, -20, corr=7)]
    many = trace.summarize(ev, {"ils_decode": 1}, {"ils_decode_kernel"})
    assert many["lost_launches"] == 1 and many["launches_ok"]
    assert many["n_ops"] == 3 + trace.LOST_SHARE - 1
    assert many["imputed_s"] == pytest.approx(100e-9)
    # so is one of the program's kernels that the counters count and the
    # trace lacks, at the longest mean time of the program's kernels
    ev.append(_Ev("void fill", "CUDA", 902, 903, corr=100 + trace.LOST_SHARE - 1))
    gone = trace.summarize(ev, {"ils_decode": 2}, {"ils_decode_kernel"})
    assert gone["lost_launches"] == 0 and gone["missing_kernels"] == 1
    assert gone["launches_ok"] and gone["imputed_s"] == pytest.approx(100e-9)
    # both at once are more than the stage bears
    assert not trace.summarize(ev[:-1], {"ils_decode": 2},
                               {"ils_decode_kernel"})["launches_ok"]


def _ctx(stage, **kw):
    base = {"window_s": 2.0, "busy_s": 1.5, "op_s": 1.6, "imputed_s": 0.0,
            "n_ops": 80, "calls": 10, "launches_ok": True}
    base.update(kw)
    return types.SimpleNamespace(
        stages={stage: base}, host={"parse": [0.001, 0.003]}, on_card=True,
        device_kind="NVIDIA H100 80GB HBM3",
        least_bytes={stage: 3.35e9})


def test_readers_roofline_idle_and_host_spans():
    ctx = _ctx("decode")
    # 10 calls x 3.35e9 B at 3.35e12 B/s = 10 ms of a 1.6 s device time
    assert specs.metric_reader("kernel_roofline.decode").read(ctx) == pytest.approx(0.625)
    assert specs.metric_reader("device_idle.decode").read(ctx) == pytest.approx(25.0)
    pages = _ctx("pages")
    assert specs.metric_reader("device_ops_per_page").read(pages) == 8.0
    assert specs.metric_reader("parse_ms.pages").read(pages) == pytest.approx(2.0)
    assert specs.metric_reader("tables_ms.pages").read(pages) is None
    assert readings.roofline(_ctx("decode", launches_ok=False), "decode") is None
    # the time charged for lost ops counts as device time: 10 ms of 2.0 s
    assert readings.roofline(_ctx("decode", imputed_s=0.4), "decode") == pytest.approx(0.5)
    assert readings.idle(_ctx("decode", imputed_s=0.4), "decode") == pytest.approx(25.0)
    off = _ctx("decode")
    off.on_card = False
    assert readings.idle(off, "decode") is None
    other = _ctx("decode")
    other.device_kind = "some other card"
    assert readings.roofline(other, "decode") is None


def test_window_rates_are_all_bytes_over_all_time(monkeypatch):
    bulk = specs.loop("bulk")
    clock = iter(np.arange(0, 100, 0.25))
    monkeypatch.setattr(bulk.time, "perf_counter", lambda: float(next(clock)))
    run = types.SimpleNamespace(
        tracer=trace.Tracer(False, "cpu"), device=torch.device("cpu"),
        note=lambda m: None)
    n, failed, elapsed, kept = bulk._calls(run, "decode", lambda n: 10 + n,
                                           1.5, {0})
    # each call reads the clock four times (its start, the span's two, its
    # end): calls end at 1.0 and 2.0, and the half's time runs to the last
    assert (n, failed) == (2, 0) and elapsed == pytest.approx(2.0)
    assert kept == {0: 10, 1: 11}


def test_bulk_calls_take_the_inputs_in_turn():
    seen = []
    driver = specs.driver("ils")

    def encode(codec, data):
        seen.append(data.data_ptr())
        return driver.encode(codec, data)

    out = tiny_run("ils-r09.bulk", patch={"encode": encode}, seconds=1.2)
    assert out["correct"]
    k = TINY["ils-r09.bulk"]["mix"]["inputs"]
    # set-up encodes each input once, then the window takes them in turn
    assert len(set(seen[:k])) == k and len(seen) > 2 * k
    assert all(a == seen[i % k] for i, a in enumerate(seen[k:]))
    assert specs.mix("bulk")["inputs"] > 1


# ----------------------------------------------------------------------
# the result line
# ----------------------------------------------------------------------
@pytest.mark.parametrize("workload", sorted(TINY))
def test_result_line_shape(workload, spec):
    out = tiny_run(workload)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"]: m["unit"] for m in specs.end_to_end(spec, workload)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values())
    json.dumps(out)


def test_traced_line_has_breakdown_and_no_cpu_device_metric():
    out = tiny_run("ils-r09.pages", traced=True)
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert out["metrics"] == {}  # a CPU run reports no device metric
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_command_fails_without_a_card():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ils-r09.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
def test_reference_tables_match_the_port_and_are_optimal():
    from huffman_tpu_torch.core.canonical import canonical_code_table
    from huffman_tpu_torch.core.package_merge import package_merge_lengths

    rng = np.random.default_rng(3)
    for _ in range(30):
        freqs = rng.integers(0, 1000, 256) * (rng.random(256) < 0.6)
        freqs[rng.integers(256)] += rng.integers(1, 10**7)
        for max_len in (9, 12, 16):
            if np.count_nonzero(freqs) > 1 << max_len:
                continue
            mine = huffman.package_merge_lengths(freqs, max_len)
            theirs = package_merge_lengths(freqs, max_len)
            assert np.array_equal(mine, theirs)
            assert huffman.kraft_ok(mine, max_len)
            table = canonical_code_table(theirs, max_len)
            assert np.array_equal(huffman.canonical_codes(mine),
                                  table.codes.astype(np.int64))


@pytest.mark.parametrize("n,r,k,rot", [(200_000, 0.9, 64, "auto"),
                                       (300_001, 0.1, 64, True),
                                       (70_000, 0.5, None, "auto")])
def test_ils_reference_agrees_with_the_port(n, r, k, rot):
    from huffman_tpu_torch import IlsCodec
    from huffman_tpu_torch.io import write_ils_container

    data = datagen.redundant(n, r, n, 1, "cpu")
    codec = IlsCodec.fit(data, k=k, rotate=rot, device="cpu")
    comp = codec.encode(data)
    blob = write_ils_container(comp)
    assert ref_ils.check([blob], [data], 16, "cpu") == {
        "table_len_diff": 0, "container_byte_diff": 0, "format_faults": 0}
    out, faults = ref_ils.decode([ref_ils.parse(blob)], "cpu")
    assert faults == 0 and torch.equal(out[0], codec.decode(comp))
    assert ref_ils.check([blob], [data ^ (torch.arange(n) == n // 2)], 16,
                         "cpu")["container_byte_diff"] == 1


def test_ils_reference_holds_the_band_anchors():
    from huffman_tpu_torch import IlsCodec
    from huffman_tpu_torch.io import write_ils_container

    data = datagen.redundant(2 * 2048 * 1024, 0.5, 5, 1, "cpu")
    blob = write_ils_container(IlsCodec.fit(data, k=2048, device="cpu").encode(data))
    parsed = ref_ils.parse(blob)
    sec = parsed["sections"][0]
    assert sec["w_cap"] > 2 * sec["w_band"]  # a band narrower than the tile
    assert ref_ils.decode([parsed], "cpu")[1] == 0
    sec["boffs"] = sec["boffs"] + 4
    out, faults = ref_ils.decode([parsed], "cpu")
    assert faults > 0 and torch.equal(out[0], data)  # right bytes, wrong band


@pytest.mark.parametrize("g,bb,r,sb", [(4, 16384, 0.1, 1024), (3, 5000, 0.9, 256)])
def test_htc1_reference_agrees_with_the_port(g, bb, r, sb):
    from huffman_tpu_torch import GapArrayCodec
    from huffman_tpu_torch.io import read_container, write_container

    data = datagen.redundant(g * bb, r, g, 1, "cpu")
    codec = GapArrayCodec.fit(data, seg_bits=sb, block_bytes=bb, device="cpu")
    blob = write_container(codec.encode(data))
    assert ref_htc1.check([blob], [data], 16, "cpu") == {
        "table_len_diff": 0, "container_byte_diff": 0, "format_faults": 0}
    out, faults = ref_htc1.decode(ref_htc1.parse(blob), "cpu")
    assert faults == 0 and torch.equal(out, codec.decode(read_container(blob)))
    c = ref_htc1.parse(blob)
    c["metas"][0] = c["metas"][0].copy()
    c["metas"][0][3] ^= 1 << 4  # one segment's count off by one
    assert ref_htc1.decode(c, "cpu")[1] > 0


# ----------------------------------------------------------------------
# the import guard
# ----------------------------------------------------------------------
GUARD = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests.test_bench_harness import tiny_run, TINY
from benchmark import control
for w in TINY:
    assert tiny_run(w, seconds=0.1)["correct"]
assert not control.run_seed("ils-r09.bulk", 3, 0.1, "cpu",
                            overrides=TINY["ils-r09.bulk"])["correct"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REF_ONLY = """
import sys
sys.path.insert(0, {root!r})
import torch
from benchmark.reference import huffman, ils, htc1
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("script", [GUARD, REF_ONLY], ids=["harness", "reference"])
def test_no_jax_and_a_reference_apart_from_the_program(script):
    p = subprocess.run([sys.executable, "-c", script.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600, cwd="/")
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "huffman_tpu"}
    if script is REF_ONLY:
        assert "huffman_tpu_torch" not in top


def test_no_benchmark_source_imports_jax_and_the_reference_no_program():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"jax", "jaxlib", "flax", "huffman_tpu"}, path
        if path.parent.name == "reference":
            assert "huffman_tpu_torch" not in names, path


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ils-r09.pages",
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and "device_idle.pages" in out["metrics"]
