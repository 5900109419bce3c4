"""The cell of four cards, ``ils-r05x4.sharded``, on the CPU: its ranks as
four gloo processes at the size ``tiny/ils-r05x4.sharded.json`` gives
(`benchmark/ranks.py`).  The sound run reads ``correct``; the control's
override (`control_sharded.py`) and a decode whose ordered gather swaps
two ranks' bytes (a driver under ``tests/parts/``) read not correct; and
the readers of the cell's per-layer metrics do their arithmetic on a
synthetic traced context, and read None without one.

    python -m pytest benchmark/tests/test_bench_sharded.py -q
"""

import copy
import json
import types

import pytest

from benchmark import control_sharded, spec as specs
from benchmark.tests.test_bench_harness import PARTS, rank_run, tiny_run

CELL = "ils-r05x4.sharded"
SEED = 2**31 + 4242


def _run(spec, cell, overrides, parts=None):
    p = rank_run(spec, cell, SEED, 0.6, False, 4, parts, overrides)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_cell_runs_on_four_ranks_and_reads_correct():
    out = tiny_run(CELL, seed=SEED, seconds=0.6)
    assert out["correct"] and out["device"]["count"] == 4
    assert set(out["metrics"]) == {"decode_gbps", "ratio", "setup_s"}
    assert set(out["checks"]) == {"table_len_diff", "container_byte_diff",
                                  "format_faults", "decode_byte_diff",
                                  "missing_answers"}


def test_the_control_reads_not_correct():
    tiny = specs.tiny(CELL)
    over = {key: {**tiny.get(key, {}),
                  **control_sharded.OVERRIDE.get(key, {})}
            for key in ("config", "mix")}
    out = _run(specs.load_spec(), CELL, over)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert not out["correct"] and checks["table_len_diff"] > 0
    assert checks["decode_byte_diff"] == checks["missing_answers"] == 0
    # the command the control runs for each seed carries the override
    cmd = control_sharded.ranks_command(CELL, 1, 2.0, 4, "cuda", tiny)
    assert '"control_stride": 16' in cmd[-1]


def _swapped_spec(spec):
    """BENCHMARK.json with the cell copied onto a driver whose decode
    swaps rank 0's and rank 1's bytes (``tests/parts/``)."""
    spec = copy.deepcopy(spec)
    spec["configs"].append({
        "name": "ils-r05x4-swapped", "source": "https://example.org/tests-only",
        "file": "benchmark/tests/parts/configs/ils-r05x4-swapped.json",
        "reduced": ["chips"], "why": "a fault planted in the ordered gather"})
    spec["workloads"].append({
        "name": "ils-r05x4-swapped.sharded", "config": "ils-r05x4-swapped",
        "traffic": "sharded", "chips": 4, "why": "tests only"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("ils-r05x4-swapped.sharded")
    return spec


def test_a_gather_out_of_order_reads_decode_byte_diff():
    name = "ils-r05x4-swapped.sharded"
    out = _run(_swapped_spec(specs.load_spec()), name, specs.tiny(name, PARTS),
               PARTS)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert not out["correct"] and checks["decode_byte_diff"] > 0
    # the encodes and their containers are sound
    assert checks["table_len_diff"] == checks["container_byte_diff"] == 0


def _span(sid, name, parent, call, **attrs):
    return {"name": name, "start_ns": 0, "end_ns": 1, "id": sid,
            "parent": parent, "call": call, "attrs": attrs}


def _ctx(on_card=True, kind="NVIDIA H100 80GB HBM3"):
    whole = 4 * 2**30
    spans = [
        _span(1, "ils.shard_encode", 0, 1, counts={
            "host_syncs.histogram": 1, "host_syncs.certify": 1,
            "host_syncs.row_starts": 1, "collectives.all_reduce": 1,
            "collectives.all_gather": 1, "collective_bytes": 4000}),
        _span(2, "coll.all_reduce", 1, 1, op="all_reduce", bytes=2072, world=4),
        _span(3, "ils.shard_encode", 0, 3, counts={
            "host_syncs.histogram": 1, "host_syncs.certify": 2,
            "host_syncs.row_starts": 2, "collectives.all_reduce": 1,
            "collectives.all_gather": 3, "collective_bytes": 9000}),
        # two decodes, each gathering the whole stream in 10 ms
        _span(4, "ils.shard_decode", 0, 4, counts={}),
        _span(5, "ils.gather", 4, 4, device_s=0.0101),
        _span(6, "coll.all_gather", 5, 4, op="all_gather", bytes=whole,
              world=4, device_s=0.01),
        _span(7, "ils.shard_decode", 0, 7, counts={}),
        _span(8, "ils.gather", 7, 7, device_s=0.0101),
        _span(9, "coll.all_gather", 8, 7, op="all_gather", bytes=whole,
              world=4, device_s=0.01),
        # a collective outside any gather is not the gather's
        _span(10, "coll.all_reduce", 7, 7, op="all_reduce", bytes=8, world=4,
              device_s=5.0),
    ]
    return types.SimpleNamespace(
        stages={"decode": {"window_s": 2.0, "busy_s": 1.7, "op_s": 1.8,
                           "imputed_s": 0.0, "calls": 2, "launches_ok": True}},
        host={}, on_card=on_card, device_kind=kind, least_bytes={},
        window={"encode_gbps": 640.5, "decode_gbps": 300.0},
        program_spans=spans)


NAMES = ("gather_roofline.shard_decode", "device_idle.shard_decode",
         "encode_gbps.shard", "host_syncs.shard_encode",
         "collectives.shard_encode")


def test_the_cells_readers_on_a_traced_context():
    ctx = _ctx()

    def read(name):
        return specs.metric_reader(name).read(ctx)

    # 3/4 of 4 GiB received a call at 450 GB/s, over 10 ms of the gather
    assert read("gather_roofline.shard_decode") == pytest.approx(
        100 * 0.75 * 4 * 2**30 / 450e9 / 0.01)
    assert read("device_idle.shard_decode") == pytest.approx(15.0)
    assert read("encode_gbps.shard") == 640.5
    assert read("host_syncs.shard_encode") == 4.0     # (3 + 5) / 2 calls
    assert read("collectives.shard_encode") == 3.0    # (2 + 4) / 2 calls
    spec = specs.load_spec()
    assert [m["name"] for m in specs.per_layer(spec, CELL)] == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_the_cells_readers_read_none_without_records(name):
    reader = specs.metric_reader(name)
    assert reader.read(_ctx(on_card=False)) is None
    ctx = _ctx()
    ctx.program_spans, ctx.stages, ctx.window = None, {}, {}
    assert reader.read(ctx) is None
    if name == "gather_roofline.shard_decode":  # no peak for another card
        assert reader.read(_ctx(kind="some other card")) is None
