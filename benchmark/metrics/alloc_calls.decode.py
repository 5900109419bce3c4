"""The caching allocator's own cudaMalloc and cudaFree calls across a
traced decode call, per call: the program's ``alloc_calls``."""

from benchmark.program import DECODE, mean_per_call


def read(ctx):
    return mean_per_call(ctx, DECODE, "alloc_calls", always=False)
