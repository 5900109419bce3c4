"""Host syncs a traced encode call makes: the program's count of each
site that reads device values on the host or copies host memory to the
device (`trace.to_host` / `to_device`), per call."""

from benchmark.program import ENCODE, mean_per_call


def read(ctx):
    return mean_per_call(ctx, ENCODE, "host_syncs")
