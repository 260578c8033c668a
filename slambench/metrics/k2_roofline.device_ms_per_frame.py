"""K2's share of its roofline in the profiled stretch of the detector: the
least time the H100's int8 tensor cores need for the operations K2's
launches must do (every pair of descriptor sets matched, Ka × Kb
distances of 512 operations each: ``drivers/detect.k2_ops``), over K2's
device time by name."""

from slambench.harness import peaks

MOVES = "device_ms_per_frame"
UNIT = "%"
KERNEL = "hamming_wgmma_kernel"


def read(rec):
    t = sum(v[1] for k, v in rec.get("kernels", {}).items() if KERNEL in k)
    if t <= 0 or not rec.get("k2_ops"):
        return None
    return 100.0 * rec["k2_ops"] / peaks.INT8_OPS / t
