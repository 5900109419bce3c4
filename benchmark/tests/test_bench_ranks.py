"""The rank path of a cell of more than one card (`benchmark/ranks.py`),
on four gloo ranks on the CPU, through the probe cell that only the tests
see (``tests/parts/``: each rank all-reduces a tensor made from the seed
and its rank, and rank 0 checks the sum): the result line reports four
cards and the fullest card's peak, every rank stops after the same call,
rank 0's window waits for the slowest rank's set-up, and a rank that
fails, or whose rank 0 is gone, ends the run within 60 s with no result
line.

    python -m pytest benchmark/tests/test_bench_ranks.py -q
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from benchmark import spec as specs
from benchmark.tests.test_bench_harness import PARTS, ROOT, probe_spec, rank_run

SEED = 2**31 + 777


@pytest.fixture(scope="module")
def probe():
    return probe_spec(specs.load_spec())


def _run(probe, seconds=1.0, **mix):
    t = time.monotonic()
    overrides = {**specs.tiny("probe.x4", PARTS), "mix": mix}
    p = rank_run(probe, "probe.x4", SEED, seconds, False, 4, PARTS, overrides)
    return p, time.monotonic() - t


def _result(p):
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None


def test_four_ranks_report_the_fullest_card_and_stop_together(probe):
    fake = 123_456_789
    p, _ = _run(probe, fault="fake_peak", fault_rank=2, fake_peak_bytes=fake,
                setup_sleep_s=1.0)
    assert p.returncode == 0, p.stderr[-3000:]
    out = _result(p)
    assert out["correct"] and out["device"]["count"] == 4
    assert out["device"]["memory_peak_bytes"] == fake
    assert set(out["metrics"]) == {"reduce_gbps", "setup_s"}
    calls = dict(re.findall(r"probe rank (\d): (\d+) calls", p.stdout + p.stderr))
    assert sorted(calls) == ["0", "1", "2", "3"]
    assert len(set(calls.values())) == 1 and int(calls["0"]) == out["attempted"]
    # no window starts before the slowest rank (2) has set up
    ready = dict(re.findall(r"probe rank (\d): set up at ([\d.]+)", p.stdout + p.stderr))
    start = dict(re.findall(r"probe rank (\d): window at ([\d.]+)", p.stdout + p.stderr))
    assert len(ready) == len(start) == 4
    assert min(map(float, start.values())) >= float(ready["2"])


@pytest.mark.parametrize("fault", ["raise", "exit", "kill", "forbidden"])
def test_a_rank_that_fails_ends_the_run(probe, fault):
    p, took = _run(probe, fault=fault, fault_rank=2)
    assert p.returncode != 0 and _result(p) is None, p.stderr[-3000:]
    assert took < 60
    if fault == "forbidden":
        assert p.returncode == 3 and "rank 2 loaded ['flax']" in p.stderr


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[1][0] in "ZX"
    except FileNotFoundError:
        return True


def test_a_rank_whose_rank_0_is_gone_ends(probe, tmp_path):
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(probe))
    lead = subprocess.Popen(
        [sys.executable, "-m", "benchmark.ranks", "--rank", "0", "--world", "4",
         "--device", "cpu", "--workload", "probe.x4", "--seed", str(SEED),
         "--seconds", "50", "--spec", str(path), "--parts", str(PARTS),
         "--overrides", json.dumps(specs.tiny("probe.x4", PARTS))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    pids = []
    try:
        for line in lead.stdout:  # its window has begun once set-up is done
            pids += [int(x) for x in re.findall(r"\d+ pid (\d+)", line)]
            if line.startswith("setup_s"):
                break
        assert len(pids) == 3
        lead.send_signal(signal.SIGKILL)
        lead.wait(10)
        deadline = time.monotonic() + 30
        while not all(map(_gone, pids)) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert all(map(_gone, pids))
    finally:
        lead.kill()
        lead.wait(10)
        lead.stdout.close()
        for pid in pids:
            if not _gone(pid):
                os.kill(pid, signal.SIGKILL)
