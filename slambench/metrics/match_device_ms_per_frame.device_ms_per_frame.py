"""Device time charged to the port's ``detect.match`` span per keyframe in the
profiled stretch of the detector, where the port's tracing is on: the
scoring launches over the pool (K2 and the mutual-match counts). Where the
span is absent (the port's tracing off, or a program without the span) it
reads nothing."""

MOVES = "device_ms_per_frame"
UNIT = "ms"
SPAN = "detect.match"


def read(rec):
    s = rec.get("spans", {}).get(SPAN)
    if not s or not rec.get("frames"):
        return None
    return 1e3 * s["device_s"] / rec["frames"]
