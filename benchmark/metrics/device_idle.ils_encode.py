"""``device_idle.encode`` in the cells whose encode rate is a per-layer
metric (the ILS encode, bound by the host): the same reading, under a name
of its own, since it moves another end-to-end metric there."""

from benchmark.readings import idle


def read(ctx):
    return idle(ctx, "encode")
