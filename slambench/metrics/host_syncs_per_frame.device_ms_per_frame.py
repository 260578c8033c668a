"""Host syncs per integrated frame, counted under CUDA's sync debug mode
over a stretch of the stream."""

MOVES = "device_ms_per_frame"
UNIT = "syncs"


def read(rec):
    if not rec.get("sync_frames"):
        return None
    return rec["syncs"] / rec["sync_frames"]
