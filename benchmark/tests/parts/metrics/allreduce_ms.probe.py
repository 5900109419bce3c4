"""Mean host time of one all-reduce call, to its synchronise, in the
traced window of rank 0."""

from benchmark.readings import host_mean_ms


def read(ctx):
    return host_mean_ms(ctx, "reduce")
