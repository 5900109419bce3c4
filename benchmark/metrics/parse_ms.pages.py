"""Mean host time of the benchmark's span around the container parse
(`read_ils_container` or `read_container`) in the traced page reads."""

from benchmark.readings import host_mean_ms


def read(ctx):
    return host_mean_ms(ctx, "parse")
