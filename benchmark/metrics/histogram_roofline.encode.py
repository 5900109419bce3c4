"""% of the bytes roofline of the ILS encode's histogram step: the bytes
it counts, read once at the peak HBM bandwidth, over the device time of
the program's ``ils.histogram`` spans (CUDA events at each span's ends;
the step ends by reading its counts on the host, so its work stays inside
the span), in the traced encode calls."""

from benchmark.program import calls, counted, spans
from benchmark.readings import PEAKS


def read(ctx):
    tops = {t["id"]: t for t in calls(ctx, ("ils.encode",))}
    peak = PEAKS.get(ctx.device_kind)
    if not tops or peak is None:
        return None
    nbytes = sum(counted(t, "histogram_bytes") or 0 for t in tops.values())
    device_s = sum(s["attrs"].get("device_s", 0.0) for s in spans(ctx)
                   if s["name"] == "ils.histogram" and s["call"] in tops)
    if device_s <= 0:
        return None
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / device_s
