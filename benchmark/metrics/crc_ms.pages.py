"""Host time of the container's payload CRC (the program's ``io.crc``
span inside ``read_ils_container``) per traced page request."""

from benchmark.program import per_request, spans


def read(ctx):
    crc = [s for s in spans(ctx) or () if s["name"] == "io.crc"]
    if not crc:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in crc)
    return per_request(ctx, "pages", ns / 1e6)
