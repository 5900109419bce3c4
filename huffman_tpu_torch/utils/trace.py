"""Spans and counters of the port's own layers.

A span is a named interval of host time, ``<layer>.<step>`` (``ils.encode``,
``ils.section``, ``sync.row_starts``, ``coll.all_gather``).  Each record holds its name, its
start and end (`time.perf_counter_ns`), its own id, its parent's id (0 for
a span opened outside any other) and a call id that every span of one
top-level call shares: the id of the span that opened the call.  Records
stay in memory until `drain` takes them.

Counters are plain integers in one store, always on:

- ``launches.<wrapper>``: the kernel launches of each `ops/*_kernels.py`
  wrapper, which those modules read and reset through their
  ``launch_counts`` and ``reset_launch_counts``;
- ``host_syncs.<site>``: each execution of a site that waits for the device
  or copies host memory to it, counted by `to_host` and `to_device`;
- ``ils.sections``, ``ils.passes``: ILS sections kept and pack passes run;
- ``histogram_bytes``: the bytes the ILS encode's histogram counted;
- ``gap.zero_fills``: HTC1 decodes whose output was zero-filled before B1
  placed its bytes, as their counts were not shown in range;
- ``collectives.<op>``, ``collective_bytes``: each collective of
  `parallel/mesh.py` (``all_reduce``, ``all_gather``), and the bytes of
  its rank's input and output buffers; each is also a span ``coll.<op>``;
- ``alloc_calls``: the caching allocator's own cudaMalloc and cudaFree calls
  (``num_device_alloc`` + ``num_device_free`` of `torch.cuda.memory_stats`)
  across a top-level span given a CUDA ``device``, read only while tracing.

Tracing is off by default, and off `span` returns one shared null context
after a global check: no allocation, no clock read.  It is on between
`enable` and `disable`, and while a `torch.profiler` session records.
While a profiler records, each span is also entered as a record function
named ``"htt." + name`` (PyTorch's light `_RecordFunctionFast` where it
has one, else `torch.profiler.record_function`), so it lies in the same
event list, on the same clock, as the device's operations.  While tracing:

- a top-level span's record holds, under ``counts``, what every counter
  but the launches gained during the call, and where the span names a
  CUDA ``device`` (the codecs' calls), that device's ``alloc_calls``;
- a span inside another that names a CUDA ``device`` holds, under
  ``device_s``, the interval between CUDA events recorded on that device's
  current stream as it opens and closes: the device time from the span's
  first operation to its end, for a span that ends by waiting for its own
  work.

The records are the caller's thread's: spans of one call nest on one
thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "enable", "disable", "drain", "count", "to_host",
           "to_device", "launches", "reset_launches"]

PREFIX = "htt."
LAUNCH = "launches."
SYNC = "host_syncs."

_NULL = contextlib.nullcontext()
_MARK = getattr(torch._C._profiler, "_RecordFunctionFast",
                torch.profiler.record_function)
_enabled = False
_counts: dict[str, int] = {}
_records: list = []
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Record spans from now on."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record no more spans (a running profiler still turns them on)."""
    global _enabled
    _enabled = False


def drain() -> dict:
    """The records and counters since the last drain, then cleared.

    Returns ``{"spans": [...], "counters": {...}}``; each span a dict of
    ``name``, ``start_ns``, ``end_ns``, ``id``, ``parent``, ``call`` and
    ``attrs``.  The launch counters are returned too but stay: their
    modules' ``reset_launch_counts`` clears them."""
    spans = [_as_dict(r) for r in _records]
    _records.clear()
    counters = dict(_counts)
    for key in [k for k in _counts if not k.startswith(LAUNCH)]:
        del _counts[key]
    return {"spans": spans, "counters": counters}


def _as_dict(rec) -> dict:
    name, start, end, sid, parent, call, attrs, counts, events = rec
    attrs = dict(zip(attrs[::2], attrs[1::2]))
    if counts is not None:
        attrs["counts"] = dict(zip(counts[::2], counts[1::2]))
    if events is not None:
        events[1].synchronize()
        attrs["device_s"] = events[0].elapsed_time(events[1]) / 1e3
    return {"name": name, "start_ns": start, "end_ns": end, "id": sid,
            "parent": parent, "call": call, "attrs": attrs}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def launches(wrappers) -> dict[str, int]:
    """The launch counts of the `ops` modules' ``wrappers``."""
    return {w: _counts.get(LAUNCH + w, 0) for w in wrappers}


def reset_launches(wrappers) -> None:
    for w in wrappers:
        _counts.pop(LAUNCH + w, None)


def span(name: str, device=None, **attrs):
    """A context manager around one step; see the module docstring."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name, device, attrs)
    return _NULL


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``, counted under ``host_syncs.<site>``: the caller reads
    device values on the host, so the host waits for the device."""
    key = SYNC + site
    _counts[key] = _counts.get(key, 0) + 1
    if _enabled or _profiler._is_profiler_enabled:
        with _Span("sync." + site, None, {}):
            return t.cpu()
    return t.cpu()


def to_device(a, dev, site: str) -> torch.Tensor:
    """``a`` (a NumPy array or a tensor) on ``dev`` by a plain, blocking
    ``.to(dev)``.  Counted under ``host_syncs.<site>`` where host memory
    crosses: always for a NumPy array, for a tensor where it is not on
    ``dev`` already."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    elif _on(a, dev if isinstance(dev, torch.device) else torch.device(dev)):
        return a  # what ``a.to(dev)`` returns where it copies nothing
    key = SYNC + site
    _counts[key] = _counts.get(key, 0) + 1
    if _enabled or _profiler._is_profiler_enabled:
        with _Span("sync." + site, None, {}):
            return a.to(dev)
    return a.to(dev)


def _on(a: torch.Tensor, dev: torch.device) -> bool:
    """True where ``a.to(dev)`` copies nothing."""
    if a.device.type != dev.type:
        return False
    if dev.index is None and dev.type == "cuda":
        return a.device.index == torch.cuda.current_device()
    return dev.index is None or a.device.index == dev.index


def _alloc_calls(dev: int) -> int:
    stats = torch.cuda.memory_stats_as_nested_dict(dev)
    return stats.get("num_device_alloc", 0) + stats.get("num_device_free", 0)


def _flat(d: dict) -> tuple:
    return tuple(x for kv in d.items() for x in kv)


class _Span:
    __slots__ = ("name", "device", "attrs", "id", "parent", "call", "t0",
                 "mark", "events", "before", "alloc")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        dev = None if self.device is None else torch.device(self.device)
        if dev is not None and dev.type != "cuda":
            dev = None
        self.events = self.alloc = self.before = None
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
            if dev is not None:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(torch.cuda.current_stream(dev))
        else:
            self.parent, self.call = 0, self.id
            self.before = dict(_counts)
            if dev is not None:
                index = torch.cuda.current_device() if dev.index is None \
                    else dev.index
                self.alloc = (index, _alloc_calls(index))
        self.mark = None
        if _profiler._is_profiler_enabled:
            self.mark = _MARK(PREFIX + self.name)
            self.mark.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.mark is not None:
            self.mark.__exit__(*exc)
        counts = None
        if self.before is not None:
            before = self.before
            gained = {k: v - before.get(k, 0) for k, v in _counts.items()
                      if v != before.get(k, 0) and not k.startswith(LAUNCH)}
            if self.alloc is not None:
                dev, n0 = self.alloc
                gained["alloc_calls"] = _alloc_calls(dev) - n0
                count("alloc_calls", gained["alloc_calls"])
            counts = _flat(gained)
        # flat tuples of plain values: the collector stops tracking them, so
        # a long traced run adds nothing to its full collections
        _records.append((self.name, self.t0, t1, self.id, self.parent,
                         self.call, _flat(self.attrs), counts, self.events))
        return False
