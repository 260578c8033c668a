"""Share of the stream's profiled stretch in which no operation ran on
the device (one minus the union of device-side intervals over the
stretch's wall)."""

MOVES = "device_ms_per_frame"
UNIT = "%"


def read(rec):
    if not rec.get("window_s") or not rec.get("frames"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
