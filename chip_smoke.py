#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (coxgraph_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It drives the port's per-robot integration path (HostMapper.step_batch →
integrate_batch → allocation pass + CUDA block-update kernel) and fails
(nonzero exit, no result line) if anything is wrong:

  1. device    — require a CUDA GPU; print nvidia-smi's name and power limit
  2. build     — build the kernel library from csrc/ with nvcc (sm_90a)
  3. kernel    — at the bench point (640×480, 5 cm, 16³ blocks), the kernel
                 vs its plain torch twin on the card, same inputs: integer
                 outputs equal; float pools bit-identical except at most
                 1e-3 of the live voxels differing by more than 1e-5
  4. main path — HostMapper(_mapper_config()).step_batch over the 30-frame
                 clip rendered on the card (4 submaps × 2048 blocks); one
                 kernel launch per frame; TSDF accuracy against the analytic
                 scene (median |err| < voxel, q95 < 2.5 voxel)
  5. state     — the stock MapperConfig (32 submaps × 8192 blocks × 16³,
                 21.5 GB of pools): 30 frames at 1 s with the 10 s submap
                 interval roll over at t = 0, 10, 20
  6. times     — tsdf_benchmark frames/s, and the kernel alone vs its twin

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

EVENT_REPS = 50


def _time_ms(fn, reps: int = EVENT_REPS) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls,
    after one warm-up call (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_twin(cfg, device, depths, colors, traj):
    """Phase 3 → (max_abs_err, (kernel's pools, twin's pools, the last
    frame's update arguments)) for the timing."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import cuda_tsdf
    from coxgraph_tpu_torch.ops import tsdf as tsdf_ops

    spec, icfg, intr = cfg.spec, cfg.integrator, cfg.intrinsics
    k = torch.zeros((), dtype=torch.int32, device=device)
    lk = sm.create_collection(cfg, device).layers   # kernel's pools
    lt = sm.create_collection(cfg, device).layers   # twin's pools
    planar = colors.permute(0, 3, 1, 2).contiguous()
    max_err = 0.0
    for f in range(2):          # fresh pools, then pools with weight
        T = traj[f]
        sk, mk = tsdf_ops._alloc_pass(spec, icfg, intr, lk, k, depths[f], T)
        st, mt = tsdf_ops._alloc_pass(spec, icfg, intr, lt, k, depths[f], T)
        assert torch.equal(sk, st) and torch.equal(mk, mt), "slots differ"
        for name in ("block_index", "block_coords", "num_blocks"):
            assert torch.equal(getattr(lk, name), getattr(lt, name)), name
        args = (k, sk, mk, depths[f], planar[f], geo.inverse(T))
        cuda_tsdf.update_blocks(spec, icfg, intr, lk, *args)
        cuda_tsdf.update_blocks_reference(spec, icfg, intr, lt, *args)
        torch.cuda.synchronize()
        n_live = int((lt.weight > 0).sum())
        n_diff, n_big = 0, 0
        for name in ("sdf", "weight", "color"):
            d = (getattr(lk, name) - getattr(lt, name)).abs()
            max_err = max(max_err, float(d.max()))
            n_diff += int((d > 0).sum())
            n_big += int((d > 1e-5).sum())
            assert torch.isfinite(getattr(lk, name)).all(), name
        assert n_big <= 1e-3 * n_live, (n_big, n_live)
        print(f"[3] frame {f}: live blocks {int(mk.sum())}, live voxels "
              f"{n_live}, max|d| {max_err:.3e}, differing voxels {n_diff}, "
              f"> 1e-5: {n_big}")
    assert n_live > 0 and int(mk.sum()) > 0
    return max_err, (lk, lt, args)


def phase_main_path(cfg, device, depths, colors, traj):
    """Phase 4 → launches of the main path."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.frontends import synthetic as syn
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import cuda_tsdf

    n = depths.shape[0]
    hm = sm.HostMapper(cfg, device=device)
    ts = np.arange(n, dtype=np.float64) * 0.05
    torch.cuda.synchronize()
    cuda_tsdf.LAUNCHES = 0
    t0 = time.perf_counter()
    # no device→host sync may happen on the per-frame path
    torch.cuda.set_sync_debug_mode("error")
    try:
        started = hm.step_batch(depths, colors, traj, ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_tsdf.LAUNCHES
    st = hm.state
    col = st.collection
    nb = col.layers.num_blocks.cpu().numpy()
    checksum = float(col.layers.weight.sum())
    dirty = int(st.mesh_dirty[0].sum())
    print(f"[4] step_batch: {n} frames in {wall * 1e3:.1f} ms (first call), "
          f"submaps started {started}, launches {launches}, num_blocks "
          f"{nb.tolist()}, weight checksum {checksum:.6g}, mesh_dirty[0] "
          f"{dirty}, union_watermark {int(st.union_watermark)}")
    assert started == 1 and hm.n_submaps == 1
    assert launches == n, launches
    assert nb[0] > 0 and np.isfinite(checksum) and checksum > 0
    assert dirty > 0 and int(st.frame_count) == n

    # accuracy against the analytic scene (tests/test_tsdf.py's gates)
    spec = cfg.spec
    layer = sm.get_layer(col.layers, 0)
    live = layer.weight > 0
    centers = vx.voxel_centers_of_block(spec, layer.block_coords)
    world = geo.transform_points(col.T_odom_submap[0], centers)
    true = syn.scene_sdf(syn.default_scene(device), world).reshape(
        spec.max_blocks, -1)
    near = live & (true.abs() < 0.5 * spec.truncation)
    err = (layer.sdf - true).abs()[near]
    med = float(err.median())
    q95 = float(torch.quantile(err[:1_000_000].double(), 0.95))
    print(f"[4] accuracy: {int(near.sum())} near-surface voxels, median "
          f"|err| {med:.4f} m, q95 {q95:.4f} m (voxel {spec.voxel_size})")
    assert int(near.sum()) > 1000
    assert med < spec.voxel_size and q95 < 2.5 * spec.voxel_size
    return launches


def phase_state_size(device, depths, colors, traj):
    """Phase 5: the stock MapperConfig with three rollovers."""
    from coxgraph_tpu_torch.mapper import submap_mapper as sm

    cfg = sm.MapperConfig()
    n = depths.shape[0]
    t0 = time.perf_counter()
    hm = sm.HostMapper(cfg, device=device)
    torch.cuda.synchronize()
    alloc_s = time.perf_counter() - t0
    pools = sum(t.numel() * t.element_size() for t in (
        hm.state.collection.layers.sdf, hm.state.collection.layers.weight,
        hm.state.collection.layers.color))
    t0 = time.perf_counter()
    started = hm.step_batch(depths, colors, traj,
                            np.arange(n, dtype=np.float64) * 1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = hm.state
    col = st.collection
    hist = col.hist_count.cpu().numpy()
    nb = col.layers.num_blocks.cpu().numpy()
    dirty = st.mesh_dirty.sum(dim=1).cpu().numpy()
    print(f"[5] stock config: pools {pools / 1e9:.2f} GB (allocated in "
          f"{alloc_s:.2f} s), {n} frames in {wall:.2f} s, started "
          f"{started}, n_submaps {hm.n_submaps}, constraints "
          f"{int(st.constraints.count)}, hist_count {hist[:4].tolist()}, "
          f"num_blocks {nb[:4].tolist()}, mesh_dirty rows "
          f"{dirty[:4].tolist()}, union_watermark "
          f"{int(st.union_watermark)}, dropped "
          f"{int(st.dropped_union_blocks)}")
    assert started == 3 and hm.n_submaps == 3
    assert int(col.num_submaps) == 3 and int(st.constraints.count) == 2
    assert hist[:4].tolist() == [10, 10, 10, 0], hist
    assert (nb[:3] > 0).all() and (nb[3:] == 0).all(), nb
    assert (dirty[:3] > 0).all() and (dirty[3:] == 0).all(), dirty
    assert int(st.frame_count) == n
    assert 0 < int(st.union_watermark) <= cfg.spec.max_blocks
    assert int(st.dropped_union_blocks) == 0
    start = col.start_time.cpu().numpy()[:3].tolist()
    assert start == [0.0, 10.0, 20.0], start
    del hm, st, col


def main() -> None:
    from coxgraph_tpu_torch import _build, runtime
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.ops import cuda_tsdf

    # ---- 1. device -----------------------------------------------------
    device = runtime.require_cuda()
    ident = runtime.gpu_identity()
    name = torch.cuda.get_device_name(0)
    print(f"[1] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f"; nvidia-smi: {ident}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[2] kernel library built in {_build.last_build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s): {_build.LIB_PATH}")
    with open(_build.LOG_PATH) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("[2]   " + line.strip())

    cfg = bm._mapper_config()
    t0 = time.perf_counter()
    depths, colors, traj = bm.generate_frames(device)
    torch.cuda.synchronize()
    print(f"[3] rendered {depths.shape[0]} frames "
          f"{tuple(depths.shape[1:])} on the card in "
          f"{time.perf_counter() - t0:.2f} s; valid depth share "
          f"{float((depths > 0).float().mean()):.3f}")

    # ---- 3. kernel vs twin at the bench point --------------------------
    max_err, (lk, lt, args) = phase_kernel_vs_twin(cfg, device, depths,
                                                   colors, traj)

    # ---- 6a. kernel alone vs twin, same shapes (before freeing) --------
    spec, icfg, intr = cfg.spec, cfg.integrator, cfg.intrinsics
    timings = {}
    for tag in ("plain", "kernel", "kernel", "plain"):
        if tag == "kernel":
            fn = lambda: cuda_tsdf.update_blocks(spec, icfg, intr, lk, *args)
        else:
            fn = lambda: cuda_tsdf.update_blocks_reference(spec, icfg, intr,
                                                           lt, *args)
        timings.setdefault(tag, []).append(_time_ms(fn))
    kernel_ms = min(timings["kernel"])
    plain_ms = min(timings["plain"])
    n_live = int(args[2].sum())
    print(f"[6] block update at the bench point ({args[1].shape[0]} lanes, "
          f"{n_live} live blocks): kernel {kernel_ms * 1e3:.1f} us/call "
          f"{timings['kernel']}, torch twin {plain_ms * 1e3:.1f} us/call "
          f"{timings['plain']} ms — {ident}")
    del lk, lt, args
    torch.cuda.empty_cache()

    # ---- 4. main path ----------------------------------------------------
    launches = phase_main_path(cfg, device, depths, colors, traj)
    torch.cuda.empty_cache()

    # ---- 5. real state size --------------------------------------------
    phase_state_size(device, depths, colors, traj)
    torch.cuda.empty_cache()

    # ---- 6b. end-to-end benchmark ---------------------------------------
    fps = bm.tsdf_benchmark(depths, colors, traj)
    print(f"[6] tsdf_integration_fps {fps:.2f} frames/s (4 windows x "
          f"{depths.shape[0]} frames, 640x480, 5 cm) — {ident}")

    print(json.dumps({"kernels": [{
        "name": "tsdf_update_blocks",
        "route": "cuda",
        "source": "coxgraph_tpu_torch/csrc/tsdf_update.cu",
        "replaces": "coxgraph_tpu/ops/pallas_tsdf.py:214",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
