"""Host syncs per CoxgraphServer.optimize, counted under CUDA's sync
debug mode."""

MOVES = "device_ms_per_optimize"
UNIT = "syncs"


def read(rec):
    if not rec.get("sync_optimizes"):
        return None
    return rec["syncs"] / rec["sync_optimizes"]
