"""Share of the serving cell's profiled stretch (open loop: frames at the
sensor's rate and the serves) in which no operation ran on the device."""

MOVES = "map_latency_p95_ms"
UNIT = "%"


def read(rec):
    if not rec.get("window_s") or not rec.get("serves"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
