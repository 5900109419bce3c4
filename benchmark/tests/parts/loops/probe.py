"""``probe``: on every rank, one sum across ranks after another (the
harness's tests; `benchmark/ranks.py`).

Set-up opens the program's process group at ``run.ranks.address`` and
makes the rank's tensor from the seed and the rank; rank ``extra_rank``
holds ``extra_bytes`` more.  The window sums the tensors of all ranks
call after call until rank 0 says stop (`Ranks.agree`), so every rank
makes as many calls.  The check: rank 0 compares the last sum with the
plain reference's.  The mix's ``fault`` plants what the tests need on
rank ``fault_rank`` at its call ``fault_call``: ``raise``, ``exit``
(``os._exit(1)``), ``kill`` (SIGKILL), ``forbidden`` (a stand-in module
named in run.py's ``FORBIDDEN``), or ``fake_peak`` (the rank reports
``fake_peak_bytes`` as its peak); and that rank sleeps ``setup_sleep_s``
at the end of its set-up.
"""

from __future__ import annotations

import os
import signal
import sys
import time
import types

import torch

from benchmark.traffic import sync

DRIVER_NEEDS = ("open_group", "reduce", "close_group")


def _plant(fault: str) -> None:
    print(f"plants {fault} at {time.time():.6f}", file=sys.stderr, flush=True)
    if fault == "raise":
        raise RuntimeError("a fault planted in the probe's window")
    if fault == "exit":
        os._exit(1)
    if fault == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if fault == "forbidden":
        sys.modules["flax"] = types.ModuleType("flax")


def setup(run) -> dict:
    cfg, ranks = run.config, run.ranks
    run.codec.open_group(ranks.address, ranks.world, ranks.rank, run.device)
    x = run.reference.inputs(cfg["n_bytes"], run.seed, ranks.rank, run.device)
    extra = None
    if ranks.rank == cfg["extra_rank"] and cfg["extra_bytes"]:
        extra = torch.ones(cfg["extra_bytes"], dtype=torch.uint8,
                           device=run.device)
    run.codec.reduce(x)
    sync(run.device)
    if ranks.rank == run.mix["fault_rank"]:
        if run.mix["fault"] == "fake_peak":
            run.peak_bytes = lambda: run.mix["fake_peak_bytes"]
        time.sleep(run.mix["setup_sleep_s"])
    run.note(f"probe rank {ranks.rank}: set up at {time.time():.6f}")
    return {"x": x, "extra": extra}


def window(run, st: dict, seconds: float) -> dict:
    ranks, mix = run.ranks, run.mix
    plant = ranks.rank == mix["fault_rank"]
    n, agree_s, out = 0, 0.0, None
    run.note(f"probe rank {ranks.rank}: window at {time.time():.6f}")
    with run.tracer.stage("reduce") as rec:
        t0 = time.perf_counter()
        while True:
            if plant and n == mix["fault_call"]:
                _plant(mix["fault"])
            with run.tracer.span("reduce"):
                out = run.codec.reduce(st["x"])
                sync(run.device)
            n += 1
            t = time.perf_counter()
            stop = ranks.agree(t - t0 >= seconds)
            agree_s += time.perf_counter() - t
            if stop:
                break
        elapsed = time.perf_counter() - t0
        rec["calls"] = n
    st["out"] = out
    run.note(f"probe rank {ranks.rank}: {n} calls in {elapsed:.6f} s, agree "
             f"{1e6 * agree_s / n:.3f} us a call, peak {run.peak_bytes()} B")
    return {"attempted": n, "failed": 0,
            "reduce_gbps": n * run.config["n_bytes"] / elapsed / 1e9}


def check(run, st: dict, res: dict) -> dict:
    out = st.pop("out")
    st.clear()
    run.free()
    counts = {}
    if run.ranks.rank == 0:
        counts = run.reference.check(out, run.config["n_bytes"], run.seed,
                                     run.ranks.world, run.device)
    run.codec.close_group()
    return counts
