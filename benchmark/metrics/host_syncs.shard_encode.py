"""Host syncs a traced sharded encode call makes on rank 0 (the program's
``host_syncs.<site>`` across `ils.shard_encode`), per call."""

from benchmark.program import mean_per_call


def read(ctx):
    return mean_per_call(ctx, ("ils.shard_encode",), "host_syncs")
