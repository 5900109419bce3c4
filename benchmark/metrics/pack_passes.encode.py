"""ILS pack passes run per section kept in the traced encode calls
(``ils.passes`` / ``ils.sections``): 1.0 where every section certifies on
its first pass; an escalated anchor, a rotated re-encode, a two-pass
fallback or a halved k each add a pass."""

from benchmark.program import calls, counted


def read(ctx):
    tops = calls(ctx, ("ils.encode",))
    passes = sum(counted(t, "ils.passes") or 0 for t in tops)
    sections = sum(counted(t, "ils.sections") or 0 for t in tops)
    return passes / sections if sections else None
