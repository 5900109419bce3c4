"""``host_syncs.encode`` in the cells whose encode rate is a per-layer
metric (the ILS encode, bound by the host): the same count, under a name
of its own, since it moves another end-to-end metric there."""

from benchmark.program import ENCODE, mean_per_call


def read(ctx):
    return mean_per_call(ctx, ENCODE, "host_syncs")
