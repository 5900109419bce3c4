"""``kernel_roofline.encode`` in the cells whose encode rate is a
per-layer metric (the ILS encode, bound by the host): the same reading,
under a name of its own, since it moves another end-to-end metric there."""

from benchmark.readings import roofline


def read(ctx):
    return roofline(ctx, "encode")
