"""The caching allocator's own cudaMalloc and cudaFree calls (the latter
synchronises the device) across a traced encode call, per call: the
program's ``alloc_calls``."""

from benchmark.program import ENCODE, mean_per_call


def read(ctx):
    return mean_per_call(ctx, ENCODE, "alloc_calls", always=False)
