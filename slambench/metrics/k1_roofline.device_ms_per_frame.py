"""K1's share of its roofline in the profiled stretch of the stream: the
least time the H100 needs to move the bytes K1 must move (each block the
reference's allocation names for the stretch's frames, its sdf, weight
and colour read and written, and each frame's depth and planar colour
read once; chip_smoke.py's arithmetic), over K1's device time by name."""

from slambench.harness import peaks

MOVES = "device_ms_per_frame"
UNIT = "%"
KERNEL = "tsdf_update_blocks_kernel"


def read(rec):
    t = sum(v[1] for k, v in rec.get("kernels", {}).items() if KERNEL in k)
    if t <= 0 or not rec.get("k1_bytes"):
        return None
    return 100.0 * rec["k1_bytes"] / peaks.HBM_BYTES_PER_S / t
