"""``pages``: one caller, a closed loop of page reads.

Set-up makes a pool of ``pool`` pages whose sizes spread log-uniformly over
[``min_bytes``, ``max_bytes``] (the same sizes for every seed, in a seeded
order), each its own container with its own table, and reads each once
through the request path.  Requests walk seeded permutations of the pool,
and each reads one page through the driver's ``read``, output on the
device; latency runs from issue to the synchronise after it.  The check
judges every page's table and container, every set-up read, and the
answers of ``SAMPLE_SIZE`` requests drawn from the seed among the first
``SAMPLE_BELOW``.
"""

from __future__ import annotations

import time

import torch

from benchmark import datagen
from benchmark.reference.huffman import diff_bytes
from benchmark.traffic import DATA, ORDER, SAMPLE, p95, slices, sync

SAMPLE_BELOW, SAMPLE_SIZE = 100_000, 512
DRIVER_NEEDS = ("fit", "pack", "read")


def setup(run) -> dict:
    cfg, mix = run.config, run.mix
    sizes = datagen.log_uniform_sizes(mix["pool"], mix["min_bytes"],
                                      mix["max_bytes"])
    sizes = sizes[datagen.rng(run.seed, ORDER).permutation(sizes.size)]
    buf = datagen.redundant(int(sizes.sum()), cfg["redundancy"], run.seed,
                            DATA, run.device)
    pages = list(torch.split(buf, sizes.tolist()))
    blobs = [run.codec.pack(run.codec.fit(cfg, p), p) for p in pages]
    # one pass over the pool through the request path; its outputs are
    # judged after the window, beside the window's own
    warm = [run.codec.read(b, run.device, run.tracer.span) for b in blobs]
    sync(run.device)
    run.tracer.host.clear()
    return {"pages": pages, "blobs": blobs, "warm": warm}


def window(run, st: dict, seconds: float) -> dict:
    blobs = st["blobs"]
    order = datagen.rng(run.seed, ORDER)
    keep = set(datagen.rng(run.seed, SAMPLE).choice(
        SAMPLE_BELOW, size=SAMPLE_SIZE, replace=False).tolist())
    lat, ends, kept, failed, seq = [], [], [], 0, []
    with run.tracer.stage("pages") as rec:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if not seq:
                seq = order.permutation(len(blobs)).tolist()
            page = seq.pop()
            t = time.perf_counter()
            with run.tracer.span("request"):
                try:
                    out = run.codec.read(blobs[page], run.device, run.tracer.span)
                    with run.tracer.span("sync"):
                        sync(run.device)
                except Exception as exc:  # a failed request counts; the run goes on
                    run.note(f"request {len(lat)} failed: {exc!r}")
                    failed += 1
                    out = None
            lat.append(time.perf_counter() - t)
            ends.append(t + lat[-1] - t0)
            if len(lat) - 1 in keep:
                kept.append((page, out))
        rec["calls"] = len(lat)
    st["kept"] = kept
    med = sorted(lat)[len(lat) // 2]
    run.note(f"{len(lat)} requests, median {med * 1e3:.6f} ms, p95 "
             f"{p95(lat) * 1e3:.6f} ms, max {max(lat) * 1e3:.6f} ms, kept "
             f"{len(kept)}; median ms by second of the window "
             f"{[round(1e3 * x, 4) for x in slices(ends, lat, 1.0)]}")
    return {"attempted": len(lat), "failed": failed,
            "page_p95_ms": p95(lat) * 1e3}


def check(run, st: dict, res: dict) -> dict:
    pages, blobs = st["pages"], st["blobs"]
    answers = [(i, o) for i, o in enumerate(st.pop("warm"))] + st.pop("kept")
    run.free()
    counts = run.reference.check(blobs, pages, run.config["max_len"],
                                 run.device)
    counts["decode_byte_diff"] = sum(
        diff_bytes(o, pages[i]) for i, o in answers if o is not None)
    counts["missing_answers"] = res["failed"] + sum(o is None for _, o in answers)
    return counts
