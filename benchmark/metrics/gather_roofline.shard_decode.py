"""% of the NVLink roofline of the ordered gather in the traced sharded
decode calls (rank 0, `ils.shard_decode`): the bytes one card must
receive, (D - 1) / D of the whole stream a call, at one direction's peak
NVLink bandwidth, over the device time of the collectives inside the
calls' `ils.gather` spans (CUDA events at each collective's ends, the end
after the card's stream has waited for it).  The bytes are the gather's
result, whatever implements it: an all-gather, or a zero-filled SUM."""

from benchmark.program import calls, spans

# NVLink 4 on the H100 SXM: 18 links, 900 GB/s both directions, 450 GB/s
# in one (NVIDIA H100 Tensor Core GPU data sheet), at the 700 W limit
NVLINK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 450e9}


def read(ctx):
    tops = {t["id"] for t in calls(ctx, ("ils.shard_decode",))}
    peak = NVLINK_BYTES_PER_S.get(ctx.device_kind)
    if not tops or peak is None:
        return None
    every = spans(ctx)
    gathers = {s["id"] for s in every
               if s["name"] == "ils.gather" and s["call"] in tops}
    colls = [s for s in every
             if s["parent"] in gathers and s["name"].startswith("coll.")]
    device_s = sum(s["attrs"].get("device_s", 0.0) for s in colls)
    if device_s <= 0:
        return None
    need = sum(s["attrs"]["bytes"] * (s["attrs"]["world"] - 1)
               / s["attrs"]["world"] for s in colls)
    return 100.0 * need / peak / device_s
