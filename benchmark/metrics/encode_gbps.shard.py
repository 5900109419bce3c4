"""The sharded encode's rate in a traced window: the whole stream's bytes
(every rank's) of every encode call of the window's first half over rank
0's time of that half, the profiler's cost included.  Per layer, since
the encode is bound by the host, whose speed wanders from run to run by
more than an end-to-end bound can hold (`encode_gbps.ils`)."""


def read(ctx):
    rate = getattr(ctx, "window", {}).get("encode_gbps")
    return rate if ctx.on_card and rate else None
