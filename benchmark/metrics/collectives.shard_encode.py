"""Collectives a traced sharded encode call runs on rank 0 (the program's
``collectives.<op>`` across `ils.shard_encode`: the counts' all-reduce,
the certification's gather of the tiles' envelopes, and each retry's or
rotated pass's), per call."""

from benchmark.program import mean_per_call


def read(ctx):
    return mean_per_call(ctx, ("ils.shard_encode",), "collectives")
