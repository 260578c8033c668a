"""Kernel launches per CoxgraphServer.optimize in the profiled stretch."""

MOVES = "device_ms_per_optimize"
UNIT = "launches"


def read(rec):
    if not rec.get("optimizes"):
        return None
    return rec["launches"] / rec["optimizes"]
