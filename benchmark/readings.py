"""What the per-layer readers share: rooflines and idle shares of a
traced stage, and the table of peaks.

A reader returns None where it has nothing sound to read: no traced
stage, a run off the card, a trace that lost more launches than
`trace.LOST_SHARE` bears, or a device missing from `peaks.json`.  The few
it bears are charged (`trace.summarize`): a roofline adds their time to
the device time, an idle share leaves it out, so each reads worse, never
better, than the whole trace would.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def stage(ctx, name: str):
    st = ctx.stages.get(name)
    if not ctx.on_card or st is None or not st["launches_ok"] or not st["calls"]:
        return None
    return st


def roofline(ctx, name: str):
    """% of the bytes bound: the least bytes the calls need (the data's
    bytes once plus the container's once) over peak bandwidth, divided by
    all device time in the stage's calls, with the time charged for the
    ops the trace lost."""
    st = stage(ctx, name)
    peak = PEAKS.get(ctx.device_kind)
    if st is None or peak is None or st["op_s"] <= 0:
        return None
    need = st["calls"] * ctx.least_bytes[name] / peak["hbm_bytes_per_s"]
    return 100.0 * need / (st["op_s"] + st["imputed_s"])


def idle(ctx, name: str):
    """% of the stage's wall time in which no device operation ran."""
    st = stage(ctx, name)
    if st is None or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])


def host_mean_ms(ctx, span: str):
    """Mean host time of one benchmark span in the traced window."""
    times = ctx.host.get(span)
    return 1e3 * sum(times) / len(times) if times and ctx.on_card else None
