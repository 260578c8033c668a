"""Wall time per CoxgraphServer.optimize over the traced run's bare
stretch (timed before its profiler starts), closed loop, each ending in
its poses read back: what the server's solve takes after a fusion. The
host paces it, and the host's speed moves it by more than a bound can
hold, so it is read here and the card's time per optimize stands end to
end."""

MOVES = "device_ms_per_optimize"
UNIT = "ms"


def read(rec):
    return rec.get("optimize_ms")
