"""Kernel launches per integrated frame in the profiled stretch of the
stream (the host's cost of issuing the allocation pass and K1)."""

MOVES = "device_ms_per_frame"
UNIT = "launches"


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["launches"] / rec["frames"]
