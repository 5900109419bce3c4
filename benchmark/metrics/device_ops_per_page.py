"""Device operations (kernels, copies, sets) in the traced page reads,
per request."""

from benchmark.readings import stage


def read(ctx):
    st = stage(ctx, "pages")
    return None if st is None else st["n_ops"] / st["calls"]
