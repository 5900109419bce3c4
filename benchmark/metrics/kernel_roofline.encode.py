"""% of the bytes roofline over every device operation of the traced
encode calls: the data's bytes once plus the container's once, at the peak
HBM bandwidth, over the summed device time."""

from benchmark.readings import roofline


def read(ctx):
    return roofline(ctx, "encode")
