"""Mean host time of the benchmark's span around the codec's construction
from the parsed table (`IlsCodec(table)`: the device tables and their
copies) in the traced page reads."""

from benchmark.readings import host_mean_ms


def read(ctx):
    return host_mean_ms(ctx, "tables")
