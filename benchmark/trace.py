"""The benchmark's spans and the reduction of a device trace to numbers.

`Tracer.span` times a call into one layer on the host clock, and in a
traced run also marks it for `torch.profiler`.  `Tracer.stage` profiles
one stage of the window (``--trace 1`` only) and reduces its trace to a
summary: the device operations (kernels, copies, sets) with their total
and busy time, the idle gaps named by the innermost span the host was in
(summed by span, and the longest few each with its span and its start in
the stage), and a check that the trace holds the stage's kernel launches.
The profiler has been seen to drop a few device records in some 80,000:
library launches that the runtime recorded, and the program's own kernels,
which its wrappers' launch counters count.  What is missing is charged
against the readings: each lost op at the longest mean time of an op of
its kind (the program's kernels or the library's) in the stage, so a
roofline can only read low, and an idle share, which leaves it out, only
high.  Where more than one in ``LOST_SHARE`` of the stage's launches is
missing the stage's device readings are left out.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import pkgutil
import re
import time

import torch

LAUNCH_APIS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"}
PREFIX = "bench."
STAGE = PREFIX + "stage"
LOST_SHARE = 1_000
LONGEST = 10


class Counters:
    """The program's kernel launch counters, from every ``*_kernels``
    module of its ``ops`` package, and its kernels' names."""

    def __init__(self):
        import huffman_tpu_torch.ops as ops

        self.mods = [importlib.import_module(f"{ops.__name__}.{m.name}")
                     for m in pkgutil.iter_modules(ops.__path__)
                     if m.name.endswith("_kernels")]
        self.mods = [m for m in self.mods if hasattr(m, "launch_counts")]

    def reset(self) -> None:
        for m in self.mods:
            m.reset_launch_counts()

    def read(self) -> dict[str, int]:
        out = {}
        for m in self.mods:
            out.update(m.launch_counts())
        return out

    @staticmethod
    def kernel_names() -> set[str]:
        from huffman_tpu_torch.ops.cuda_build import kernel_resources

        names = set()
        for mangled in kernel_resources():
            m = re.match(r"_Z(\d+)(\w+)", mangled)
            names.add(m.group(2)[: int(m.group(1))] if m else mangled)
        return names


def _ident(kernel: str) -> str:
    m = re.match(r"(?:void )?([A-Za-z_]\w*)", kernel)
    return m.group(1) if m else kernel


def _timeline(spans):
    """Cut points (t, innermost span name) of properly nested spans."""
    cuts, stack = [], []

    def pop_until(t):
        while stack and stack[-1][2] <= t:
            end = stack.pop()[2]
            cuts.append((end, stack[-1][0] if stack else None))

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        pop_until(s)
        stack.append((name, s, e))
        cuts.append((s, name))
    pop_until(float("inf"))
    return [c[0] for c in cuts], [c[1] for c in cuts]


def summarize(events, launches: dict[str, int], port: set[str]) -> dict:
    """Reduce one stage's kineto events to the numbers the readers use."""
    ops, spans, api = [], [], []
    stage = None
    for e in events:
        name = e.name()
        on_dev = str(e.device_type()).endswith("CUDA")
        if on_dev and not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
        elif not on_dev and e.is_user_annotation() and name.startswith(PREFIX):
            if name == STAGE:
                stage = (e.start_ns(), e.end_ns())
            else:
                spans.append((name[len(PREFIX):], e.start_ns(), e.end_ns()))
        elif not on_dev and name in LAUNCH_APIS:
            api.append((e.start_ns(), e.correlation_id()))
    if stage is None:
        raise RuntimeError("the trace holds no stage span")
    lo, hi = stage
    # what the stage launched: the settling launch before it is left out
    kernels = {o[3] for o in ops}
    api = {c for t, c in api if lo <= t <= hi}
    ops = [o for o in ops if lo <= o[1] <= hi]
    by_name, n_by_name = collections.Counter(), collections.Counter()
    for name, s, e, _ in ops:
        by_name[name] += (e - s) / 1e9
        n_by_name[name] += 1
    # the union of device intervals, and the gaps between them in the stage
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for _, s, e, _ in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, hi))
    starts, labels = _timeline(spans)
    idle, named = collections.Counter(), []
    for a, b in gaps:
        if b <= a:
            continue
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        label = labels[i] if i >= 0 and labels[i] else "loop"
        idle[label] += (b - a) / 1e9
        named.append((label, (b - a) / 1e9, (a - lo) / 1e9))
    n_port = sum(_ident(o[0]) in port for o in ops)
    n_wrapped = sum(launches.values())
    lost = len(api - kernels)
    missing = max(n_wrapped - n_port, 0)
    mean = {k: by_name[k] / n_by_name[k] for k in by_name}
    longest = [max((t for k, t in mean.items() if (_ident(k) in port) == mine),
                   default=0.0) for mine in (True, False)]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "op_s": sum(by_name.values()),
        "n_ops": len(ops),
        "ops_by_name": dict(by_name),
        "idle_by_span": dict(idle),
        "longest_gaps": sorted(named, key=lambda g: -g[1])[:LONGEST],
        "port_kernels": n_port,
        "wrapper_launches": n_wrapped,
        "lost_launches": lost,
        "launches": len(api),
        "missing_kernels": missing,
        "imputed_s": missing * longest[0] + lost * longest[1],
        "launches_ok": missing + lost <= (len(api) + n_wrapped) // LOST_SHARE,
        "launch_counts": launches,
    }


class Tracer:
    """Host-clock spans always; profiled stages in a traced run."""

    def __init__(self, traced: bool, device: torch.device):
        self.traced = traced
        self.device = torch.device(device)
        self.host = collections.defaultdict(list)
        self.stages: dict[str, dict] = {}
        self._profiling = False
        self._counters = Counters() if traced else None

    @contextlib.contextmanager
    def span(self, name: str):
        mark = (torch.profiler.record_function(PREFIX + name)
                if self._profiling else contextlib.nullcontext())
        t = time.perf_counter()
        with mark:
            yield
        self.host[name].append(time.perf_counter() - t)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Profile the body (traced runs only).  The body sets ``calls`` in
        the dict it is given: the calls or requests the stage made."""
        rec = {"calls": 0}
        if not self.traced:
            yield rec
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        on_card = self.device.type == "cuda"
        port = Counters.kernel_names() if on_card else set()
        self._counters.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # one launch and a synchronise before the stage, so the device's
            # records are flowing when its first launch comes
            torch.zeros(1, device=self.device).add_(1)
            if on_card:
                torch.cuda.synchronize()
            self._profiling = True
            try:
                with record_function(STAGE):
                    yield rec
                    if on_card:
                        torch.cuda.synchronize()
            finally:
                self._profiling = False
        summary = summarize(prof.profiler.kineto_results.events(),
                            self._counters.read(), port)
        summary["calls"] = rec["calls"]
        self.stages[name] = summary
