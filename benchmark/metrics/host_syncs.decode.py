"""Host syncs a traced decode call makes (`trace.to_host` / `to_device`
sites), per call."""

from benchmark.program import DECODE, mean_per_call


def read(ctx):
    return mean_per_call(ctx, DECODE, "host_syncs")
