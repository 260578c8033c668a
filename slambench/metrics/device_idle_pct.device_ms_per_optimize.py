"""Share of the solve's profiled stretch (back-to-back optimizes) in
which no operation ran on the device."""

MOVES = "device_ms_per_optimize"
UNIT = "%"


def read(rec):
    if not rec.get("window_s") or not rec.get("optimizes"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
