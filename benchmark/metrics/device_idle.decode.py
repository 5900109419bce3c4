"""% of the traced decode stage's wall time in which no device operation
ran (1 - the union of device intervals over the wall time)."""

from benchmark.readings import idle


def read(ctx):
    return idle(ctx, "decode")
