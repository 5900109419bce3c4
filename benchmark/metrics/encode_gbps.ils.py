"""The encode rate of a traced window, taken as ``encode_gbps`` is: the
input bytes of every encode call of the window's first half over that
half's whole wall time, the profiler's cost included.  It stands for
``encode_gbps`` where the encode is bound by the host, whose speed wanders
from run to run by more than an end-to-end bound can hold."""


def read(ctx):
    rate = getattr(ctx, "window", {}).get("encode_gbps")
    return rate if ctx.on_card and rate else None
