"""% of rank 0's traced decode stage, in a cell of several cards, in
which no device operation ran (1 - the union of device intervals over the
wall time): A1 on the card's tiles and the ordered gather, and the host
and the other ranks between them."""

from benchmark.readings import idle


def read(ctx):
    return idle(ctx, "decode")
