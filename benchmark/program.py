"""What the readers of the program's own spans and counters share.

The program (`huffman_tpu_torch/utils/trace.py`) records its spans, and
each top-level call's counters, while a `torch.profiler` session records:
in a traced run, the traced stages and nothing else.  `spans` takes them
from the program once a run.  A reader returns None off the card, and
where the program keeps no such records (a version without the module).
"""

from __future__ import annotations

ENCODE = ("ils.encode", "gap.encode")
DECODE = ("ils.decode", "gap.decode")


def spans(ctx):
    """The program's span records of the run's traced stages, or None."""
    if not ctx.on_card:
        return None
    if not hasattr(ctx, "program_spans"):
        try:
            from huffman_tpu_torch.utils import trace
        except ImportError:
            ctx.program_spans = None
        else:
            ctx.program_spans = trace.drain()["spans"]
    return ctx.program_spans


def calls(ctx, names=None) -> list:
    """The top-level spans (one a call into the program) of the given
    names, or of every name."""
    return [s for s in spans(ctx) or ()
            if s["parent"] == 0 and (names is None or s["name"] in names)]


def counted(top: dict, prefix: str):
    """A call's gain of the counters named ``prefix`` or ``prefix.*``,
    None where the call recorded none of that name."""
    got = [v for k, v in top["attrs"].get("counts", {}).items()
           if k == prefix or k.startswith(prefix + ".")]
    return sum(got) if got else None


def mean_per_call(ctx, names, prefix: str, *, always: bool = True):
    """The counters' mean gain over the calls of ``names``.  ``always``:
    a call that gained nothing counts 0 (the counts are always on); else
    only calls that read the counter count (it is read where it can be)."""
    tops = calls(ctx, names)
    got = [counted(t, prefix) for t in tops]
    if not always:
        got = [g for g in got if g is not None]
    return sum(g or 0 for g in got) / len(got) if got else None


def per_request(ctx, stage: str, total):
    """``total`` over the requests of a traced stage."""
    st = ctx.stages.get(stage)
    return None if total is None or not st or not st["calls"] else total / st["calls"]
