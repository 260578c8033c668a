#!/usr/bin/env python3
"""Where the time of the serving stages goes, on a CUDA GPU.

    python3 tools/profile_torch_serve.py [--top 12]

Renders the bench clip with the PyTorch port (coxgraph_tpu_torch),
integrates it into one submap at the bench operating point, then traces
each serving stage of ``eval.benchmarks.stage_benchmark`` once, warm, with
torch.profiler (CPU and CUDA activities): the full mesh extraction
(``extract_mesh``, quantized readback), the batch ESDF build and the
layer merge at the identity pose into an empty doubled pool. For each
stage it prints the wall time, the summed device time of its kernels,
the device busy share (one stream, so kernels do not overlap), the
kernel launches, and the kernels that take the most device time. Fails
when no CUDA GPU is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from chip_smoke import print_top, profiled  # noqa: E402


def trace(name: str, fn, top: int) -> None:
    """Trace one call of ``fn`` and print its breakdown."""
    wall_ms, dev_ms, launches, events, kernels, _ = profiled(fn)
    print(f"{name}: wall {wall_ms:.3f} ms (profiled), device time "
          f"{dev_ms:.3f} ms, device busy share {dev_ms / wall_ms:.3f}, "
          f"kernel launches {launches}")
    print_top(events, kernels, top, host=False)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import esdf as esdf_ops
    from coxgraph_tpu_torch.ops import merge as merge_ops
    from coxgraph_tpu_torch.ops import mesh as mesh_ops

    device = runtime.require_cuda()
    print(runtime.gpu_identity())
    cfg = bm._mapper_config()
    spec = cfg.spec
    depths, colors, traj = bm.generate_frames(device)
    n = depths.shape[0]
    ts = torch.arange(n, dtype=torch.float32, device=device) * 0.05
    state = sm.create_mapper(cfg, device)
    sm.start_submap(cfg, state, traj[0], ts[0])
    sm.integrate_batch(cfg, state, depths, colors, traj, ts)
    layer = sm.get_layer(state.collection.layers, 0)
    print(f"bench map: {int(layer.num_blocks)} of {spec.max_blocks} blocks")

    dst_spec = dataclasses.replace(spec, max_blocks=2 * spec.max_blocks)
    pose = geo.identity(device)

    def mesh():
        return mesh_ops.extract_mesh(spec, layer, min_weight=0.1)

    def esdf():
        return esdf_ops.esdf_from_tsdf(spec, layer)

    def merge_into(dst):
        return lambda: merge_ops.merge_layer_into_sized(
            dst_spec, dst, layer, pose, src_spec=spec)

    # each stage warm, and the merge destinations built outside the trace,
    # as stage_benchmark keeps them outside merge_ms
    mesh(), esdf(), merge_into(vx.create_tsdf_layer(dst_spec, device))()
    trace("extract_mesh (quantized readback)", mesh, args.top)
    trace("esdf_from_tsdf", esdf, args.top)
    trace("merge_layer_into_sized (identity, empty doubled pool)",
          merge_into(vx.create_tsdf_layer(dst_spec, device)), args.top)


if __name__ == "__main__":
    main()
