"""What the traffic loops (``loops/<loop>.py``) share.

A mix is a data file (``mixes/<traffic>.json``) whose ``loop`` names the
loop that reads it and whose other keys are the loop's parameters; the
configuration gives the data's size and distribution.  Each loop is a
module with three functions, all on a `Run` (`run.py`): ``setup(run)``
makes the inputs from the seed and warms up every shape the window uses,
``window(run, st, seconds)`` drives the program for the given seconds and
returns the end-to-end numbers, ``check(run, st, res)`` hands what the
window produced to the plain reference once the window has closed and
returns the counts compared with `limits.json`.
"""

from __future__ import annotations

import math

import torch

# purposes of the seed's sub-streams
DATA, ORDER, SAMPLE = 1, 2, 3


def p95(values) -> float:
    """The nearest-rank 95th percentile: at least 95% of the values are at
    or below it."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def slices(ends, values, width: float) -> list:
    """Median of ``values`` in each ``width``-second slice of the window,
    by the time each ended: a drift within a run shows here."""
    out, lo = [], 0
    for k in range(1, int(ends[-1] // width) + 2):
        hi = next((i for i in range(lo, len(ends)) if ends[i] >= k * width), len(ends))
        if hi > lo:
            out.append(round(sorted(values[lo:hi])[(hi - lo) // 2], 6))
        lo = hi
    return out


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
