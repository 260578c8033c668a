"""Block chunks the incremental mesher re-meshed per serve in the traced
stretch (the difference of ``IncrementalMesher.chunks_remeshed`` across
each serve)."""

MOVES = "map_latency_p95_ms"
UNIT = "chunks"


def read(rec):
    c = rec.get("chunks")
    if not c:
        return None
    return sum(c) / len(c)
