"""Where a codec call's host and device time fall, by the port's own spans.

    python tools/span_breakdown_torch.py --codec ils|htc1 [--inputs 8]
        [--seconds 10] [--seed 1] [--same]

Makes ``--inputs`` distinct inputs on the card (the benchmark's configs:
ILS 10^9 B at r=0.9, HTC1 64 blocks of 16 MiB at r=0.1; each byte one of
'A'-'D' with probability r, else uniform), fits a codec to each, then
for each half (encode, decode) calls them in turn (``--same``: the first
input only) for ``--seconds`` under `torch.profiler`, each call ending in
a synchronise.  While the profiler records, the port records its spans
(`huffman_tpu_torch/utils/trace.py`).  Prints one JSON line a half:

- ``per_call``: calls, median and max ms, the counters' gain per call;
- ``idle_ms_by_span``: device idle time per call, each gap charged to the
  innermost ``htt.*`` span the host was in at the gap's middle;
- ``device_ms_by_span``: device time per call, each op charged to the
  innermost span its runtime launch fell in (by correlation id);
- ``longest_gaps``: the ten longest idle gaps (span, ms);
- ``self_ms_by_span``: host time per call inside each span and outside
  its children;
- ``slow_calls``: the five slowest calls, each span's host ms beside the
  median of that span over all calls, and the ms of the interpreter's
  garbage collections inside the call;
- ``gc``: the collections in the half (count, ms), the five longest.

Runs on a CUDA device only; imports torch, the port and the benchmark's
span timeline (`benchmark/trace.py`).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from huffman_tpu_torch import GapArrayCodec, IlsCodec  # noqa: E402
from benchmark.trace import _timeline  # noqa: E402
from huffman_tpu_torch.utils import trace  # noqa: E402

LAUNCH = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
          "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"}
STAGE = "span_breakdown.stage"
CONFIGS = {"ils": dict(n=10**9, r=0.9), "htc1": dict(n=1 << 30, r=0.1)}


def make(n: int, r: float, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.rand(n, device="cuda", generator=g) < r
    abcd = torch.randint(65, 69, (n,), device="cuda", generator=g,
                         dtype=torch.uint8)
    rest = torch.randint(0, 256, (n,), device="cuda", generator=g,
                         dtype=torch.uint8)
    return torch.where(pick, abcd, rest)


def at(starts, names, t):
    i = bisect.bisect_right(starts, t) - 1
    return (names[i] if i >= 0 else None) or "outside"


def reduce_events(events, lo, hi, calls):
    ops, spans, launch = [], [], {}
    for e in events:
        dev = str(e.device_type()).endswith("CUDA")
        if dev and not e.is_user_annotation():
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
        elif not dev and e.name().startswith("htt."):
            spans.append((e.name()[4:], e.start_ns(), e.end_ns()))
        elif not dev and e.name() in LAUNCH:
            launch[e.correlation_id()] = e.start_ns()
    starts, names = _timeline(spans)
    ops = sorted(o for o in ops if lo <= o[0] <= hi)
    device = collections.Counter()
    for s, e, corr in ops:
        t = launch.get(corr)
        device["(no launch record)" if t is None else at(starts, names, t)] += e - s
    idle, gaps, cur = collections.Counter(), [], lo
    for s, e, _ in ops:
        if s > cur:
            name = at(starts, names, (cur + s) / 2)
            idle[name] += s - cur
            gaps.append((round((s - cur) / 1e6, 4), name))
        cur = max(cur, e)
    if hi > cur:
        name = at(starts, names, (cur + hi) / 2)
        idle[name] += hi - cur
        gaps.append((round((hi - cur) / 1e6, 4), name))
    per = lambda c: {k: round(v / 1e6 / calls, 4) for k, v in  # noqa: E731
                     sorted(c.items(), key=lambda kv: -kv[1])}
    return {"idle_ms_by_span": per(idle), "device_ms_by_span": per(device),
            "longest_gaps": sorted(gaps, reverse=True)[:10]}


def per_call(records, pauses):
    tops = [s for s in records if s["parent"] == 0]
    by_id = {s["id"]: s["name"] for s in records}
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in tops]
    gained = collections.Counter()
    for t in tops:
        gained.update(t["attrs"].get("counts", {}))
    by_call = collections.defaultdict(lambda: collections.Counter())
    own = collections.Counter()
    for s in records:
        own[s["name"]] += s["end_ns"] - s["start_ns"]
        if s["parent"]:
            by_call[s["call"]][s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e6
            own[by_id[s["parent"]]] -= s["end_ns"] - s["start_ns"]
    med = {n: statistics.median(c[n] for c in by_call.values())
           for n in {n for c in by_call.values() for n in c}}
    slow = sorted(tops, key=lambda t: t["start_ns"] - t["end_ns"])[:5]
    return {
        "per_call": {"calls": len(tops), "median_ms": round(statistics.median(ms), 4),
                     "max_ms": round(max(ms), 4),
                     "counts": {k: v / len(tops) for k, v in sorted(gained.items())}},
        "self_ms_by_span": {k: round(v / 1e6 / len(tops), 4) for k, v in
                            sorted(own.items(), key=lambda kv: -kv[1])},
        "slow_calls": [{"ms": round((t["end_ns"] - t["start_ns"]) / 1e6, 4),
                        "counts": t["attrs"].get("counts", {}),
                        "gc_ms": round(sum(
                            min(e, t["end_ns"]) - max(s, t["start_ns"])
                            for s, e, _ in pauses
                            if s < t["end_ns"] and e > t["start_ns"]) / 1e6, 4),
                        "spans_ms_vs_median": {
                            n: [round(v, 4), round(med[n], 4)]
                            for n, v in by_call[t["id"]].items()}}
                       for t in slow],
    }


def half(name, fn, k, seconds):
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.drain()
    pauses, begun = [], {}

    def watch(phase, info):
        if phase == "start":
            begun["t"] = time.perf_counter_ns()
        elif "t" in begun:
            pauses.append((begun.pop("t"), time.perf_counter_ns(),
                           info["generation"]))

    gc.callbacks.append(watch)
    n = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function(STAGE):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                fn(n % k)
                torch.cuda.synchronize()
                n += 1
    gc.callbacks.remove(watch)
    records = trace.drain()["spans"]
    events = list(prof.profiler.kineto_results.events())
    stage = next(e for e in events if e.name() == STAGE
                 and not str(e.device_type()).endswith("CUDA"))
    ms = sorted(((e - s) / 1e6, g) for s, e, g in pauses)
    return {"half": name, **per_call(records, pauses),
            **reduce_events(events, stage.start_ns(), stage.end_ns(), n),
            "gc": {"count": len(ms), "ms": round(sum(m for m, _ in ms), 4),
                   "longest": [[round(m, 4), g] for m, g in ms[-5:]]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", choices=sorted(CONFIGS), required=True)
    ap.add_argument("--inputs", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--same", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg = CONFIGS[args.codec]
    data = [make(cfg["n"], cfg["r"], args.seed * 1000 + i)
            for i in range(args.inputs)]
    if args.codec == "ils":
        codecs = [IlsCodec.fit(d, max_len=16) for d in data]
        enc = lambda c, d: c.encode(d)  # noqa: E731
        dec = lambda c, x: c.decode(x)  # noqa: E731
    else:
        data = [d.view(64, -1) for d in data]
        codecs = [GapArrayCodec.fit(d, max_len=16, block_bytes=1 << 24)
                  for d in data]
        enc = lambda c, d: c.encode_device(d)  # noqa: E731
        dec = lambda c, x: c.decode_device(x)  # noqa: E731
    comps = [enc(c, d) for c, d in zip(codecs, data)]
    for c, x in zip(codecs, comps):
        dec(c, x)
    torch.cuda.synchronize()
    # as the benchmark does: the set-up's objects leave the collector's scans
    gc.collect()
    gc.freeze()
    k = 1 if args.same else args.inputs
    for name, fn in (("encode", lambda i: enc(codecs[i], data[i])),
                     ("decode", lambda i: dec(codecs[i], comps[i]))):
        out = half(name, fn, k, args.seconds)
        out.update(codec=args.codec, inputs=k,
                   device=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
