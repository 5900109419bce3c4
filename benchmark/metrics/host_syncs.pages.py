"""Host syncs of a traced page read (parse, tables and decode:
`trace.to_host` / `to_device` sites), per request."""

from benchmark.program import calls, counted, per_request


def read(ctx):
    tops = calls(ctx)
    total = sum(counted(t, "host_syncs") or 0 for t in tops) if tops else None
    return per_request(ctx, "pages", total)
