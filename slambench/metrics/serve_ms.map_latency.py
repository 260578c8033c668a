"""Mean wall of one serve (live mesh and ESDF built and read back) in the
traced stretch, from the driver's span around it."""

MOVES = "map_latency_p95_ms"
UNIT = "ms"


def read(rec):
    s = rec.get("serve_s")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
