#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (coxgraph_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It drives the port's per-robot integration path (HostMapper.step_batch →
integrate_batch → allocation pass + CUDA block-update kernel K1), its
multi-robot loop-detection path (LoopDetector → features → the CUDA
Hamming kernel K2 → RANSAC), its serving path (step_batch, then live
meshing, ESDF and layer merge, in plain torch), its solve path (LM
pose graph, dense registration, the two-phase global optimize, in plain
torch), its collaborative server tier (two robots through
VIOInterface, the loop detector and the fusion server), its
distributed deployment (robot processes on the card serving submaps over
the native bus, the mesh-with-history transport, point clouds) and its
parallel tier (an 8-robot fleet, the distributed solve, the sharded ESDF,
merge and mesh over torch.distributed), its drivers (the single-robot
demo, and the endurance mission's four threads on one card), its root
bench entry (bench_torch.py, in a fresh process) and its real-sequence
path (TUM-RGBD fixtures through the mapper, the detector on real texture
and the intra-client route to the local solve) and fails (nonzero exit,
no result line) if anything is wrong:

  1. device    — require a CUDA GPU; print nvidia-smi's name and power limit
  2. build     — build the kernel library from csrc/ with nvcc (sm_90a);
                 K2's SASS must hold tensor-core instructions (cuobjdump)
  3. kernel    — at the bench point (640×480, 5 cm, 16³ blocks), the kernel
                 vs its plain torch twin on the card, same inputs: integer
                 outputs equal; float pools bit-identical except at most
                 1e-3 of the live voxels differing by more than 1e-5; the
                 allocation pass's two kernels on the kernel's pools and
                 its plain version on the twin's: slots, slot_mask and
                 block tables equal (torch.equal), as in every later
                 "K1 ≡ its twin"
  4. main path — HostMapper(_mapper_config()).step_batch over the 30-frame
                 clip rendered on the card (4 submaps × 2048 blocks); one
                 K1 launch and two allocation-kernel launches per frame,
                 no host sync; TSDF accuracy
                 against the analytic scene (median |err| < voxel, q95 <
                 2.5 voxel); K1's live lanes per frame (min / median /
                 max), counted in a separate untimed allocation run
  5. state     — the stock MapperConfig (32 submaps × 8192 blocks × 16³,
                 21.5 GB of pools): 30 frames at 1 s with the 10 s submap
                 interval roll over at t = 0, 10, 20
  6. times     — the allocation pass at client_vga's shapes (the stock
                 MapperConfig: stride 4, 3 samples, 64³ grid, 8,192
                 blocks, 2,048 lanes) over the 30-frame clip: its kernels
                 ≡ its plain version on every frame (slots, mask, tables,
                 touched bitmap), then both timed on a steady frame (back
                 to back, profiled device time and launches, the kernels'
                 CUDA-graph device time) beside the bytes' bound;
                 tsdf_benchmark frames/s; K1 alone at the bench frame:
                 back to back through the wrapper (CUDA events) vs its
                 twin, and its device time from CUDA-graph replays, cold
                 (the calls cycle over ≥ 100 MB of distinct pool rows,
                 twice the L2, so rows come from HBM) and warm (the same
                 rows every call)
  7. K2        — hamming_match_topk at (128, 96), (384, 200), self-match
                 and the edge shapes Ka in {100, 200} x Kb in {1, 7, 200};
                 the batched masked matcher at those edge shapes (b shared
                 over 4 and 140 slots, and per query; invalid rows,
                 columns, slots, queries; ties across columns, rows and
                 slots), at the endurance point (8 queries × 512 slots ×
                 384²) and the stock point (4 × 2048 × 512²), ~90% valid:
                 kernel ≡ plain version (and ≡ the ±1 bf16 matmul route)
                 on every integer output, and so the verify launches' form
                 (b per query) at (16, 1, 384²) and (2, 1, 512²);
                 CUDA-event times of the three back to back at the main
                 path's shapes, and the kernel's device time from
                 CUDA-graph replays; the bound is the least of the popc,
                 int8 and bf16 tensor-core floors
  8. main path — the endurance detector (tools/endurance_run.py: K = 384,
                 512 slots, 8-frame sub-batches, 64-slot match chunks) on
                 two robots' 640×480 frames rendered on the card, through
                 add_keyframes_batch and add_keyframe: a 0 → 1 MapFusion
                 within 0.08 m of the ground truth, no same-robot message,
                 K2 launched; host syncs per sub-batch counted
  9. state     — the stock LoopDetectorConfig (2048 slots × 512 keypoints,
                 32 MB descriptor pool) loaded through utils.interop and
                 filled past capacity through ingest_keypoints and one
                 8-member sub-batch: evictions, per-client balance, each
                 member in its own slot, a revisit still detected
 10. serving   — at the bench point, the clip in four windows through
                 HostMapper.step_batch (no host sync; K1 launched once per
                 frame), live_mesh after each window equal to
                 extract_mesh(quantize=False) of the same layer, also after
                 a live_mesh_async whose finish() was dropped; ESDF band
                 equal to the TSDF and |dist| ≤ max_distance; the ESDF
                 kernels ≡ the plain sweeps on that layer at 2 m and at
                 client_vga's 4 m (dist's bits and observed, all rows;
                 1 + n_iters launches a build), both timed at 4 m beside
                 the live rows' bytes bound; a merge at
                 the identity pose into an empty doubled pool keeps every
                 live block with weights within bf16 rounding; kernel
                 launches per mesh extraction, ESDF build and merge
                 (torch.profiler); stage_benchmark's dict
 11. solve     — run right after phase 5, on its mapper: (a) the bench
                 solve point (solve_benchmark_problem: 64 submaps, 125
                 pairs; SolverConfig(iterations=10), 6 phase-2
                 iterations, registration weight 30): solve_benchmark's
                 solve_s / solve_best_s, a 7-value cost trace that never
                 rises, the pair alignment cost below 0.3× its initial
                 value, finite poses; phase 1 run with any host sync an
                 error, a solve with 6 phase-2 iterations syncing as
                 often as one with none (the count printed), launches
                 per LM iteration (torch.profiler), peak device memory;
                 (b) the stock mapper: a loop closure 0→2, finish_map
                 with optimize_local sync-free, 30 stamped poses from
                 trajectory, optimize_two_phase over the three stock
                 layers (non-increasing trace), a candidate check, and
                 register_pair(0, 1) from test_registration.py's
                 perturbation, sync-free: the cost falling, > 200
                 inliers, the pose error printed (the reference walks
                 away there too), the normal equations at the start ≡
                 the CPU's (1e-4 of their max); (c) the
                 card's optimize_two_phase at 8 submaps ≡ the CPU's
                 (poses 1e-4 m / rad, trace 1e-4 relative)

 12. servers   — the collaborative server tier through the port of
                 examples/two_robot_demo.py at the demo's own point
                 (eval.demos.TwoRobotDemo: 2 robots × 40 frames at
                 160×120, 5 cm voxels, 2,048 blocks × 8 submaps a client,
                 a 48-submap server with async PGO, the detector at K =
                 384, the final mesh at 6,144 blocks): the demo's gates
                 (≥ 1 fusion, no solve error, max ATE < 0.13 m, > 1,000
                 triangles, surface p90 < 4 voxels); K1 launched once per
                 integrated frame, K2 at least once; the isolated final
                 mesh leaves T_G_cli, the submap poses, the constraint
                 pool and its kinds unchanged; 0 host syncs for a fusion
                 with the solve off on held submaps; one optimize's syncs,
                 launches and busy share, one frame's; the server's
                 optimize on the card ≡ the CPU's (1e-4 m / rad) on
                 tests/test_server.py's small world without registration,
                 and with it on that world with the orbits raised 0.3 m
                 (the level world's registration samples sit on the voxel
                 lattice; its difference is printed)
 13. deployed  — the distributed deployment (eval.demos.distributed_demo,
                 the flow of examples/experiment_driver.py) at the
                 two-robot demo's point: two robot processes (spawned) on
                 the card, each rendering its two_robot_experiment clip
                 and serving its submaps over the native bus to the
                 fusion server here (RemoteClient, RemoteVIO,
                 ServerService); the fusion accepted, client-frame error
                 < 0.35, > 1,000 triangles, > 10 pose rows, K1 once per
                 integrated frame in each robot, every pulled submap ≡
                 the robot's own copy within one wire step; the robots'
                 finished submaps as meshes with history over the
                 submap_mesh topic, each recovered on the card with both
                 methods (p90 |SDF| < 2 voxels, > 100 triangles, message
                 < 0.5 × the voxel bytes, "projective" K1 once per
                 keyframe); K1 ≡ its twin (phase 3's gate) at the demo's
                 1,024 lanes on two robot frames and on the recovered
                 keyframe of most points (a render_points splat);
                 examples/pointcloud_demo.py's gates on 24
                 shuffled 160×120 clouds, and step_points timed at
                 19,200 and 307,200 points at the bench spec

 14. parallel  — the parallel tier (parallel/, eval.dryrun) on a
                 world-size-1 NCCL group (FileStore in a temporary
                 directory): 8 robots at the bench point (0.67 GB of pools
                 each), each orbiting its own sector, 30 fleet_steps under
                 sync-debug error (K1 launched 240 times, 8 on the trace of
                 one step), 3 submaps a robot, each robot ≡ its mapper_step
                 run alone (integers equal, phase 3's gate); K1 ≡ its twin
                 at the fleet's shapes; fleet_optimize from drifted submap
                 poses with the dry run's closures (the pose error falls, LM
                 iterations add no host sync, ≡ a CPU gloo world-1 run
                 within 1e-4 m / rad, the counted collective bytes beside
                 ici_bytes_per_optimize); the sharded ESDF ≡ esdf_from_tsdf
                 bit for bit on robot 0's first submap and on the dry run's
                 sphere (8 slabs); the sharded merge of the fleet's 24
                 submaps into a doubled pool within test_merge_sharded.py's
                 gates of the merge_layer_into loop, its sharded mesh ≡
                 extract_mesh(quantize=False); phase 12's server's final
                 mesh with device_mesh against its unsharded one (merged
                 layers within the gates, triangles matched within one
                 uint16 quantum); dryrun_multichip(8) at world size 1 and
                 over two gloo ranks spawned on the card (poses within
                 1e-5, ESDF equal, merge within the gates)
 15. drivers   — eval.demos.single_robot_demo at its defaults (60 frames at
                 160×120, 4,096 blocks × 16 submaps): its gate (ATE after
                 the closure and PGO < max(2.5 × before, 0.08 m), > 1,000
                 triangles), K1 once per frame; K1 ≡ its twin (phase 3's
                 gate) on two endurance frames at the mission's shapes
                 (1,024 blocks, 512 lanes); an endurance mission of 2 laps
                 (2 robots × 192 frames, burst; eval.endurance) with its
                 stream, serving, detector and solve threads on the card:
                 no error from any thread or solve, ≥ 1 fusion, max ATE <
                 0.25 m, > 1,000 triangles, surface p90 < 4 voxels, every
                 thread joined, K1 once per integrated frame, K2 launched
 16. bench     — ``python3 bench_torch.py`` (the port's root bench entry)
                 in a fresh process from the repository root: its last
                 stdout line is bench.py's JSON line, with exactly its
                 keys (the nine stage keys and the four solve keys in
                 extra_metrics), value > 0, mesh_tris > 1000, solve_pairs
                 ≥ 100, dropped_union_blocks 0, and K1 launched once per
                 frame of its five integration windows (its stderr); the
                 line printed beside phase 6's in-script headline
 17. replay    — the JAX package's real-sequence tests on the card
                 (eval.demos): tum_pipeline on tests/fixtures/tum_tiny
                 (ATE < 5e-3 m, ≥ 2 submaps, > 300 mesh vertices, surface
                 q90 < 0.3 m), drift_correction on tum_loop (drifted ATE
                 > 0.045 m, ≥ 1 routed closure, corrected < 0.75 ×
                 drifted) and on tum_real (drifted > 0.08 m, ≥ 10
                 closures, ≥ 10 routed, corrected < 0.8 × drifted and <
                 0.10 m), the mapper's pose mirror equal to the device's;
                 K1 once per frame, K2 on the detector's path; decode,
                 upload and step ms a frame, detection ms, syncs and K2
                 launches a keyframe, routing + local PGO ms and syncs a
                 routed closure; K1 ≡ its twin (phase 3's gate) on the two
                 tum_real frames with the most depth holes; K2 ≡ its plain
                 version on the detector's real-texture pool at its
                 scoring launch (1 query × 128 slots × 512²) and verify
                 launch, timed at the former beside its bound

The line before the last is the card's nvidia-smi name and power limit,
the one before it the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

EVENT_REPS = 50
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak rate
F32_FLOPS = 67e12              # f32 outside the tensor cores
BF16_FLOPS = 989e12            # dense bf16 tensor cores
INT8_OPS = 1979e12             # dense int8 tensor cores
POPC_PER_CLOCK_PER_SM = 16     # CUDA C++ Programming Guide, cc 9.0
BIG = 10_000                   # features.match_descriptors' mask value
# K2's operating points: (queries per sub-batch, pool slots, keypoints,
# slots per kernel launch) of the endurance and the stock detector
K2_POINTS = {"endurance": (8, 512, 384, 64), "stock": (4, 2048, 512, 128)}
# K2's edge shapes: Ka not a multiple of its row tiles, Kb of 1, 7, 200
K2_EDGES = tuple((ka, kb) for ka in (100, 200) for kb in (1, 7, 200))


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


def capture(fn, reps: int):
    """A CUDA graph of ``reps`` calls of ``fn``, captured after a warm-up
    call and replayed once."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return graph


def _graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, after
    a warm-up call and replay. A microsecond kernel behind a Python wrapper
    is otherwise timed at the host's call rate."""
    graph = capture(fn, reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0]) * 1e6


def _tensor_core_instructions(build, kernel: str) -> int:
    """Integer tensor-core instructions (mma.sync's IMMA, wgmma's IGMMA)
    in the SASS of the built library's functions whose name holds
    ``kernel``."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.LIB_PATH],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    n, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and ("IMMA" in line or "IGMMA" in line):
            n += 1
    return n


def _bound_ms(n_bytes: float, ops: float, ops_per_s: float):
    """(least time in ms, "bytes" or "operations") for moving n_bytes at
    the HBM rate and doing ops at ops_per_s."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def alloc_against_plain(spec, icfg, intr, lk, lt, k, depth, T, marks,
                        touched=(None, None)):
    """One frame through the allocation pass's two kernels on ``lk`` and
    through its plain version on ``lt`` (same inputs) → the kernels'
    (slots, slot_mask). Slots, slot_mask, the three block tables of every
    submap and the ``touched`` bitmaps (kernels', plain's) must be equal
    (torch.equal), and the kernels' scratch ``marks`` zero again."""
    from coxgraph_tpu_torch.ops import cuda_alloc

    sk, mk = cuda_alloc.alloc_pass(spec, icfg, intr, lk, k, depth, T,
                                   touched[0], marks)
    sp, mp = cuda_alloc.alloc_pass_reference(spec, icfg, intr, lt, k, depth,
                                             T, touched[1])
    assert torch.equal(sk, sp) and torch.equal(mk, mp), "slots differ"
    for name in ("block_index", "block_coords", "num_blocks"):
        assert torch.equal(getattr(lk, name), getattr(lt, name)), name
    if touched[0] is not None:
        assert torch.equal(touched[0][:-1], touched[1][:-1]), "touched"
    assert int(marks.count_nonzero()) == 0, "scratch left marked"
    return sk, mk


def k1_against_twin(cfg, device, frames, tag: str, icfg=None):
    """K1 ≡ its plain twin on the same inputs: fresh pools of ``cfg``'s
    collection for each, every frame of ``frames`` ((k, depth, planar
    colour (3,H,W), T_sm_cam)) through the allocation pass, its kernels
    on the kernel's pools and its plain version on the twin's
    (``alloc_against_plain``: slots and block tables equal), then the
    kernel and the twin on those lanes; at most 1e-3 of the live voxels
    may differ by more than 1e-5 after each frame. ``icfg`` overrides
    ``cfg.integrator`` → (max_abs_err, (kernel's pools, twin's pools, the
    last frame's update arguments))."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import cuda_alloc, cuda_tsdf

    spec, intr = cfg.spec, cfg.intrinsics
    icfg = cfg.integrator if icfg is None else icfg
    lk = sm.create_collection(cfg, device).layers   # kernel's pools
    lt = sm.create_collection(cfg, device).layers   # twin's pools
    marks = cuda_alloc.new_marks(spec, device)
    max_err = 0.0
    for f, (k, depth, planar, T) in enumerate(frames):
        k = torch.full((), k, dtype=torch.int32, device=device)
        sk, mk = alloc_against_plain(spec, icfg, intr, lk, lt, k, depth, T,
                                     marks)
        args = (k, sk, mk, depth, planar, geo.inverse(T))
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
        print(f"[{tag}] frame {f}: {sk.shape[0]} lanes, live blocks "
              f"{int(mk.sum())}, live voxels {n_live}, max|d| "
              f"{max_err:.3e}, differing voxels {n_diff}, > 1e-5: {n_big}")
        assert n_live > 0 and int(mk.sum()) > 0
    return max_err, (lk, lt, args)


def phase_kernel_vs_twin(cfg, device, depths, colors, traj):
    """Phase 3: K1 ≡ its twin on the bench point's first two frames (fresh
    pools, then pools with weight); ``k1_against_twin``'s result."""
    planar = colors.permute(0, 3, 1, 2).contiguous()
    return k1_against_twin(cfg, device, [(0, depths[f], planar[f], traj[f])
                                         for f in range(2)], "3")


def k1_cold_pairs(spec, layers, n_live: int):
    """The (collection, k) pairs over which K1's cold device time cycles →
    (pairs, MB of distinct pool rows per cycle). The compared frame's block
    coords and rows (submap 0 of ``layers``) go into every submap of
    ``layers`` and of copies of it, enough that one cycle over the pairs
    moves at least twice the 50 MB L2 in rows, so each call reads its rows
    from HBM."""
    from coxgraph_tpu_torch.core import voxel as vx

    S = layers.sdf.shape[0]
    for name in ("sdf", "weight", "color", "block_coords"):
        t = getattr(layers, name)
        t[1:] = t[:1]                       # the compared frame ran at k = 0
    per_col = S * n_live * 5 * spec.voxels_per_side ** 3 * 4
    n_col = max(2, -(-2 * 50_000_000 // per_col))
    cols = [layers] + [vx.TsdfLayer(**{
        f.name: getattr(layers, f.name).clone()
        for f in dataclasses.fields(layers)}) for _ in range(n_col - 1)]
    ks = [torch.full((), s, dtype=torch.int32, device=layers.sdf.device)
          for s in range(S)]
    return [(c, kk) for c in cols for kk in ks], n_col * per_col / 1e6


def round_robin(items, fn):
    """A call of no arguments that runs ``fn(*item)`` on the next of
    ``items`` each time, in turn."""
    turn = [0]

    def call():
        fn(*items[turn[0] % len(items)])
        turn[0] += 1
    return call


def k1_device_times(spec, icfg, intr, layers, args):
    """K1's device time from CUDA-graph replays → (cold ms, warm ms, MB of
    distinct pool rows per cold cycle). Cold: the captured calls cycle
    over ``k1_cold_pairs``; every call keeps the frame's slots, mask,
    images and pose. Warm: the same pools every call."""
    from coxgraph_tpu_torch.ops import cuda_tsdf

    pairs, cycle_mb = k1_cold_pairs(spec, layers, int(args[2].sum()))
    cold = round_robin(pairs, lambda c, kk: cuda_tsdf.update_blocks(
        spec, icfg, intr, c, kk, *args[1:]))
    cold_ms = _graph_ms(cold, reps=2 * len(pairs))
    warm_ms = _graph_ms(lambda: cuda_tsdf.update_blocks(
        spec, icfg, intr, layers, *args))
    del pairs, cold
    return cold_ms, warm_ms, cycle_mb


def alloc_pass_record(device, depths, traj, ident) -> dict:
    """The allocation pass at client_vga's shapes (the stock MapperConfig:
    640×480, stride 4, 3 band samples, a 64³ grid, 8,192 blocks, 2,048
    lanes) over the bench clip into one submap: its two kernels ≡ its
    plain version on every frame (``alloc_against_plain``, the window's
    touched bitmaps too). Then on the clip's last frame, whose blocks are
    allocated (a steady frame): each back to back (CUDA events), its
    device time and launches a pass (torch.profiler over 10 passes) and
    the kernels' device time from CUDA-graph replays; the bound is the
    bytes this frame's pass must move at the HBM rate → the record of the
    ``kernels`` line."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import cuda_alloc

    cfg = sm.MapperConfig()
    spec, icfg, intr = cfg.spec, cfg.integrator, cfg.intrinsics
    assert tuple(depths.shape[1:]) == (intr.height, intr.width)
    g, mb = spec.grid_dim, spec.max_blocks
    K = min(icfg.max_touched_blocks, mb)
    k = torch.zeros((), dtype=torch.int32, device=device)
    marks = cuda_alloc.new_marks(spec, device)
    T_sm_cams = geo.relative(traj[0][None], traj)   # the submap of frame 0

    def tables():           # the block tables alone (the pass's state)
        empty = torch.empty((1, 0), device=device)
        return vx.TsdfLayer(
            sdf=empty, weight=empty, color=empty,
            block_index=torch.full((1, g, g, g), -1, dtype=torch.int32,
                                   device=device),
            block_coords=torch.zeros((1, mb, 3), dtype=torch.int32,
                                     device=device),
            num_blocks=torch.zeros((1,), dtype=torch.int32, device=device))

    lk, lp = tables(), tables()
    touched = [torch.zeros(mb + 1, dtype=torch.bool, device=device)
               for _ in range(2)]
    n = depths.shape[0]
    for f in range(n):
        _, mask = alloc_against_plain(spec, icfg, intr, lk, lp, k,
                                      depths[f], T_sm_cams[f], marks,
                                      touched)
    n_blocks = int(lk.num_blocks[0])
    depth, T = depths[-1], T_sm_cams[-1]
    runs = {
        "kernels": lambda: cuda_alloc.alloc_pass(spec, icfg, intr, lk, k,
                                                 depth, T, None, marks),
        "plain": lambda: cuda_alloc.alloc_pass_reference(spec, icfg, intr,
                                                         lp, k, depth, T),
    }
    rec = {}
    for name, fn in runs.items():
        _, dev_ms, launches, _, _, _ = profiled(
            lambda fn=fn: [fn() for _ in range(10)])
        rec[name] = (_time_ms(fn), dev_ms / 10, launches / 10)
    graph_ms = _graph_ms(runs["kernels"])
    assert int(lk.num_blocks[0]) == int(lp.num_blocks[0]) == n_blocks
    assert torch.equal(lk.block_index, lp.block_index)
    assert rec["kernels"][2] == 2, rec["kernels"]
    n_live = int(mask.sum())
    st = icfg.alloc_stride
    hs, ws = -(-intr.height // st), -(-intr.width // st)
    # read: the sampled depth, the pose, the live lanes' block_index
    # entries; written: slots and slot_mask (a steady frame allocates
    # nothing)
    n_bytes = 4 * hs * ws + 4 * 7 + 4 * n_live + 5 * K
    bound, by = _bound_ms(n_bytes, 0.0, 1.0)
    print(f"[6] allocation pass at client_vga's shapes ({intr.width}x"
          f"{intr.height}, stride {st}, {icfg.alloc_band_samples} samples, "
          f"{g}^3 grid, {mb} blocks, {K} lanes): kernels ≡ plain on all {n}"
          f" frames (slots, mask, tables, touched); the last frame ({n_live}"
          f" live lanes, {n_blocks} blocks): kernels "
          f"{rec['kernels'][0] * 1e3:.2f} us back to back, device "
          f"{rec['kernels'][1] * 1e3:.2f} us profiled, "
          f"{graph_ms * 1e3:.2f} us graph, {rec['kernels'][2]:g} launches;"
          f" plain {rec['plain'][0] * 1e3:.1f} us back to back, device "
          f"{rec['plain'][1] * 1e3:.1f} us, {rec['plain'][2]:g} launches; "
          f"bound {bound * 1e3:.3f} us ({by}: {n_bytes} bytes) — {ident}")
    return dict(ms=rec["kernels"][0], device_ms=graph_ms,
                profiled_device_ms=rec["kernels"][1],
                pass_launches=rec["kernels"][2], plain_ms=rec["plain"][0],
                plain_device_ms=rec["plain"][1],
                plain_launches=rec["plain"][2], bound_ms=bound,
                bound_by=by, bound_bytes=n_bytes, live_lanes=n_live,
                frames_equal=n)


def phase_main_path(cfg, device, depths, colors, traj):
    """Phase 4 → launches of the main path (K1's, the allocation
    kernels')."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.frontends import synthetic as syn
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import cuda_alloc

    n = depths.shape[0]
    hm = sm.HostMapper(cfg, device=device)
    ts = np.arange(n, dtype=np.float64) * 0.05
    torch.cuda.synchronize()
    since = launches_since()
    t0 = time.perf_counter()
    # no device→host sync may happen on the per-frame path
    torch.cuda.set_sync_debug_mode("error")
    try:
        started = hm.step_batch(depths, colors, traj, ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = since("k1")
    st = hm.state
    col = st.collection
    nb = col.layers.num_blocks.cpu().numpy()
    checksum = float(col.layers.weight.sum())
    dirty = int(st.mesh_dirty[0].sum())
    print(f"[4] step_batch: {n} frames in {wall * 1e3:.1f} ms (first call), "
          f"submaps started {started}, launches {launches}, num_blocks "
          f"{nb.tolist()}, weight checksum {checksum:.6g}, mesh_dirty[0] "
          f"{dirty}, union_watermark {int(st.union_watermark)}")
    alloc_launches = since("alloc")
    assert started == 1 and hm.n_submaps == 1
    assert launches == n, launches
    assert alloc_launches == 2 * n, alloc_launches
    assert nb[0] > 0 and np.isfinite(checksum) and checksum > 0
    assert dirty > 0 and int(st.frame_count) == n

    # K1's live lanes per frame, counted in a separate untimed run of the
    # allocation pass on a fresh collection (a count is a host read)
    spec, icfg = cfg.spec, cfg.integrator
    fresh = sm.create_collection(cfg, device).layers
    k = torch.zeros((), dtype=torch.int32, device=device)
    T_sm_cams = geo.relative(traj[0][None], traj)   # the submap of frame 0
    marks = cuda_alloc.new_marks(spec, device)
    lanes = [int(cuda_alloc.alloc_pass(spec, icfg, cfg.intrinsics, fresh,
                                       k, depths[f], T_sm_cams[f], None,
                                       marks)[1].sum())
             for f in range(n)]
    print(f"[4] K1's live lanes per frame of the {n}: min {min(lanes)}, "
          f"median {int(np.median(lanes))}, max {max(lanes)} (of "
          f"{min(icfg.max_touched_blocks, spec.max_blocks)} lanes); blocks "
          f"allocated {int(fresh.num_blocks[0])}")
    assert int(fresh.num_blocks[0]) == nb[0], "count run left the path"
    del fresh

    # accuracy against the analytic scene (tests/test_tsdf.py's gates)
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
    return launches, alloc_launches


def phase_state_size(device, depths, colors, traj):
    """Phase 5: the stock MapperConfig with three rollovers → the
    mapper, which phase 11 goes on with."""
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
    return hm


def _words(gen, *shape, device):
    """Random descriptor words (int32 bit patterns) on the card."""
    return torch.randint(-2 ** 31, 2 ** 31, (*shape, 8), dtype=torch.int32,
                         generator=gen, device=device)


def _edge_inputs(g, nq, cap, ka, kb, batched, device):
    """Matcher inputs with every masking and tie case of K2's epilogue:
    exact matches, a row repeated (a tie across rows), a column repeated
    (across columns), slot 2 a copy of slot 1 (across slots), query row 1
    and database column 2 invalid, the last slot and (nq > 1) the last
    query wholly invalid. The tests build the same cases
    (tests/test_torch_cuda.py::edge_cases); this script stands alone, so
    it keeps its own copy."""
    a = _words(g, nq, ka, device=device)
    b = _words(g, nq if batched else 1, cap, kb, device=device)
    n = min(ka, kb) // 2
    b[:, :, :n] = a[:, None, :n] if batched else a[0, None, :n]
    b[:, :, -1] = b[:, :, 0]
    a[:, -1] = a[:, 0]
    if cap > 2:
        b[:, 2] = b[:, 1]
    av = torch.rand(nq, ka, generator=g, device=device) < 0.9
    bv = torch.rand(b.shape[:-1], generator=g, device=device) < 0.9
    av[0, 1] = False
    bv[:, 0, 2 % kb] = False
    bv[:, -1] = False
    if nq > 1:
        av[-1] = False
    return a, av, b, bv


def _matmul_route(a, av, b, bv):
    """What the JAX package's production matcher computes
    (features.hamming_matrix: one ±1 bf16 matmul, then min/argmin)."""
    from coxgraph_tpu_torch.ops import features as ft

    D = ft.hamming_matrix(a[:, None], b)
    D = torch.where(av[:, None, :, None] & bv[:, :, None, :], D, BIG)
    d1, i1 = torch.min(D, dim=-1)
    d2 = torch.min(D.scatter(-1, i1[..., None], BIG), dim=-1).values
    return d1, i1.to(torch.int32), d2, torch.argmin(D, dim=-2).to(
        torch.int32)


def _k2_bound(B, cap, ka, kb, clock_hz, n_sms, pairs=None):
    """K2's least time at one launch shape → (ms, "bytes" or
    "operations", the route of the operation floor, {route: floor ms}).
    Each distance the function needs (``pairs``; default all B·cap·Ka·Kb)
    is 8 ``__popc`` on the CUDA cores, or one 256-long ±1 dot product (512
    operations) on the tensor cores in int8 or bf16: the bound takes the
    fastest route. The bytes are every input read once and every output
    written once."""
    if pairs is None:
        pairs = B * cap * ka * kb
    n_bytes = (B * ka * 33 + cap * kb * 33          # words + valid bytes
               + 4 * B * cap * (3 * ka + kb))       # d1, i1, d2, best_a
    routes = {"popc": (8, POPC_PER_CLOCK_PER_SM * n_sms * clock_hz),
              "int8 tensor cores": (512, INT8_OPS),
              "bf16 tensor cores": (512, BF16_FLOPS)}
    floors = {r: pairs * n / rate * 1e3 for r, (n, rate) in routes.items()}
    route = min(floors, key=floors.get)
    bound, by = _bound_ms(n_bytes, pairs * routes[route][0],
                          routes[route][1])
    return bound, by, route, floors


def phase_hamming(device, ident):
    """Phase 7 → K2's record (max_abs_err, times, bound at the main
    path's launch shape)."""
    from coxgraph_tpu_torch.ops import cuda_hamming as ch

    g = torch.Generator(device=device).manual_seed(0)
    max_err = 0

    def compare(got, want, what):
        nonlocal max_err
        for x, y, name in zip(got, want, ("d1", "i1", "d2", "best_a")):
            assert x.dtype == y.dtype == torch.int32, (what, name)
            err = int((x.long() - y.long()).abs().max())
            max_err = max(max_err, err)
            assert err == 0, (what, name, err)

    for ka, kb in ((128, 96), (384, 200), (128, None)) + K2_EDGES:
        da = _words(g, ka, device=device)
        db = da if kb is None else _words(g, kb, device=device)
        if kb is not None:
            n = min(ka, kb) // 2
            db[:n] = da[:n]                     # exact matches
            db[-1] = db[0]                      # tie across columns
        got = ch.hamming_match_topk(da, db)
        compare(got, ch.hamming_match_topk_reference(da, db),
                f"topk {ka}x{kb}")
        if kb is None:
            assert int(got[0].max()) == 0
            assert torch.equal(got[1].long(),
                               torch.arange(ka, device=device))
    print(f"[7] hamming_match_topk ≡ plain at (128, 96), (384, 200), "
          f"self-match (128) and (Ka, Kb) in {K2_EDGES}")

    # edge shapes (Ka not a multiple of the tile, Kb of 1, 7, 200) with an
    # invalid row, an invalid column, a whole invalid slot and query, and
    # exact ties across columns, rows and slots; b shared and per query,
    # and shared over 140 slots (more CTAs than SMs: whole queries per CTA,
    # the launch shape of the scoring path)
    for ka, kb in K2_EDGES:
        for nq, cap, batched in ((3, 4, False), (3, 2, True),
                                 (3, 140, False)):
            a, av, b, bv = _edge_inputs(g, nq, cap, ka, kb, batched, device)
            got = ch.match_topk(a, av, b, bv, BIG, BIG)
            what = (f"edge {nq}x{cap}x{ka}x{kb} "
                    f"{'per query' if batched else 'shared'}")
            compare(got, ch.match_topk_reference(a, av, b, bv, BIG, BIG),
                    what)
            compare(got, _matmul_route(a, av, b, bv), what + " matmul")
    print(f"[7] match_topk ≡ plain ≡ matmul route at (Ka, Kb) in "
          f"{K2_EDGES}, b shared (4 and 140 slots) and per query, with "
          f"invalid rows, "
          f"columns, slots and queries and tied columns, rows and slots")

    # the verify launches: every query against its own database row (b
    # per query), at the endurance sub-batch's 8 × 2 candidates and the
    # stock single ingest's 2
    for nq, K in ((16, 384), (2, 512)):
        a = _words(g, nq, K, device=device)
        b = _words(g, nq, 1, K, device=device)
        b[:, 0, : K // 2] = a[:, : K // 2]
        av = torch.rand(nq, K, generator=g, device=device) < 0.9
        bv = torch.rand(nq, 1, K, generator=g, device=device) < 0.9
        got = ch.match_topk(a, av, b, bv, BIG, BIG)
        compare(got, ch.match_topk_reference(a, av, b, bv, BIG, BIG),
                f"verify {nq}x{K}")
        compare(got, _matmul_route(a, av, b, bv), f"verify matmul {nq}x{K}")
    print("[7] match_topk with b per query ≡ plain at (16, 1, 384²) and "
          "(2, 1, 512²)")

    clock, n_sms = _sm_clock_hz(), torch.cuda.get_device_properties(
        0).multi_processor_count
    record = {}
    for point, (B, cap, K, chunk) in K2_POINTS.items():
        a = _words(g, B, K, device=device)
        b = _words(g, 1, cap, K, device=device)
        b[0, :B, : K // 2] = a[:, : K // 2]          # revisits
        b[0, B:2 * B] = b[0, :B]                     # tied slots
        av = torch.rand(B, K, generator=g, device=device) < 0.9
        bv = torch.rand(1, cap, K, generator=g, device=device) < 0.9
        got = ch.match_topk(a, av, b, bv, BIG, BIG)
        step = 128
        for s0 in range(0, cap, step):
            sl = slice(s0, s0 + step)
            part = tuple(x[:, sl] for x in got)
            want = ch.match_topk_reference(a, av, b[:, sl], bv[:, sl],
                                           BIG, BIG)
            compare(part, want, f"{point} slots {s0}")
            compare(part, _matmul_route(a, av, b[:, sl], bv[:, sl]),
                    f"{point} matmul slots {s0}")
        n_match = int((got[0] <= 64).sum())
        del got, want
        torch.cuda.empty_cache()
        # one launch at the main path's shape, and one over the whole pool:
        # kernel, plain version and matmul route back to back between CUDA
        # events (the host wrapper included, as K1 is timed); the kernel's
        # device time alone from CUDA-graph replays
        def kernel():
            return ch.match_topk(a, av, bc, bvc, BIG, BIG)

        def pool():
            return ch.match_topk(a, av, b, bv, BIG, BIG)

        bc, bvc = b[:, :chunk].contiguous(), bv[:, :chunk].contiguous()
        fns = {"kernel": kernel, "graph": kernel,
               "plain": lambda: ch.match_topk_reference(
                   a, av, bc, bvc, BIG, BIG),
               "matmul": lambda: _matmul_route(a, av, bc, bvc)}
        times = {}
        for tag in ("plain", "kernel", "graph", "matmul", "kernel", "graph",
                    "plain", "matmul"):
            times.setdefault(tag, []).append(
                _graph_ms(fns[tag]) if tag == "graph"
                else _time_ms(fns[tag], 20 if tag == "kernel" else 5))
        pool_ms, pool_device_ms = _time_ms(pool, 10), _graph_ms(pool, 5, 4)
        bound, by, route, floors = _k2_bound(B, chunk, K, K, clock, n_sms)
        pool_bound, _, _, pool_floors = _k2_bound(B, cap, K, K, clock, n_sms)
        k_ms, dev_ms, p_ms, m_ms = (min(times[t]) for t in (
            "kernel", "graph", "plain", "matmul"))
        us, pool_us = ({r: f"{v * 1e3:.1f} us" for r, v in x.items()}
                       for x in (floors, pool_floors))
        print(f"[7] {point}: {B} queries x {cap} slots x {K}^2, "
              f"{n_match} rows with d1 <= 64; one launch of {chunk} slots "
              f"(the main path's): kernel {k_ms * 1e3:.1f} us "
              f"{times['kernel']} back to back, device time "
              f"{dev_ms * 1e3:.1f} us {times['graph']} (graph replays), "
              f"plain {p_ms * 1e3:.1f} us "
              f"{times['plain']}, matmul route {m_ms * 1e3:.1f} us "
              f"{times['matmul']}, bound {bound * 1e3:.1f} us ({by}, "
              f"{route}; floors {us}); whole pool in one launch "
              f"{pool_ms * 1e3:.1f} us back to back, device time "
              f"{pool_device_ms * 1e3:.1f} us, vs bound "
              f"{pool_bound * 1e3:.1f} us (floors {pool_us}; SM clock "
              f"{clock / 1e9:.3f} GHz, {n_sms} SMs) — {ident}")
        record[point] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                             matmul_ms=m_ms, pool_ms=pool_ms,
                             pool_device_ms=pool_device_ms,
                             bound_ms=bound, bound_by=by, bound_route=route,
                             popc_bound_ms=floors["popc"])
        del a, b, av, bv, bc, bvc
        torch.cuda.empty_cache()
    return max_err, record["endurance"]


def _ingest_two_robots(det, frames, sync_log=None):
    """Robot 0 through add_keyframes_batch (one 8-frame sub-batch, the
    rest on the single path), robot 1's first 8 frames through
    add_keyframes_batch, its last ones through add_keyframe → (messages,
    robot 1's sub-batch wall ms). Keyframes are KF_DT apart: a robot's
    whole clip lies within min_time_separation, so no same-robot pair is
    eligible."""
    from coxgraph_tpu_torch.eval.benchmarks import KF_DT

    items = [[(r, (100.0 if r else 0.0) + KF_DT * i, c, d)
              for i, (d, c) in enumerate(frames[r])] for r in (0, 1)]
    msgs = det.add_keyframes_batch(items[0])
    assert msgs == [], "robot 0 alone closed a loop"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_log is not None:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            msgs = det.add_keyframes_batch(items[1][:8])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if sync_log is not None:
        sync_log.extend(f"{w.filename.split('/')[-1]}:{w.lineno}"
                        for w in rec if "synchroniz" in str(w.message))
    for it in items[1][8:]:
        msgs = msgs + det.add_keyframe(*it)
    return msgs, wall


def phase_loop_detection(device, ident):
    """Phase 8 → K2's launches on the main path."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.frontends import loop_detector as ld

    cfg = bm.detector_config()
    t0 = time.perf_counter()
    intr, trajs, frames = bm.two_robot_clip(device)
    torch.cuda.synchronize()
    print(f"[8] rendered 2 x {len(frames[0])} frames {intr.width}x"
          f"{intr.height} on the card in {time.perf_counter() - t0:.2f} s")
    # warm-up on a throwaway detector (cuBLAS/cuSOLVER handles, caches)
    _ingest_two_robots(ld.LoopDetector(intr, cfg, device=device), frames)

    det = ld.LoopDetector(intr, cfg, device=device)
    syncs = []
    since = launches_since()
    t0 = time.perf_counter()
    msgs, sub_ms = _ingest_two_robots(det, frames, syncs)
    wall = time.perf_counter() - t0
    launches = since("k2")
    pairs = sorted({(m.from_client, m.from_time, m.to_client, m.to_time)
                    for m in msgs})
    errs = []
    for m in msgs:
        assert m.from_client != m.to_client, "same-robot message"
        assert (m.from_client, m.to_client) == (0, 1), (m.from_client,
                                                        m.to_client)
        T_true = geo.relative(
            trajs[0][int(round(m.from_time / bm.KF_DT))],
            trajs[1][int(round((m.to_time - 100.0) / bm.KF_DT))])
        err = geo.se3_log(geo.relative(
            torch.from_numpy(m.T_from_to).to(device), T_true))
        errs.append(float(torch.linalg.norm(err[3:])))
        assert np.isfinite(m.T_from_to).all() and m.sqrt_info[0, 0] == 100.0
    print(f"[8] endurance detector: {det.total_keyframes} keyframes in "
          f"{wall:.2f} s, {len(msgs)} MapFusion messages, pairs {pairs}, "
          f"translation error max {max(errs, default=float('nan')):.4f} m, "
          f"K2 launches {launches}; robot 1's 8-frame sub-batch "
          f"{sub_ms:.1f} ms wall with {len(syncs)} host sync(s) "
          f"{sorted(set(syncs))} — {ident}")
    assert msgs, "no cross-robot loop closure"
    assert max(errs) < 0.08, errs
    assert det.total_keyframes == 2 * len(frames[0])
    assert launches > 0
    return launches


def phase_detector_state(device, ident):
    """Phase 9: the stock LoopDetectorConfig filled past capacity."""
    from coxgraph_tpu_torch.frontends import loop_detector as ld
    from coxgraph_tpu_torch.frontends import synthetic as syn
    from coxgraph_tpu_torch.ops import features as ft
    from coxgraph_tpu_torch.utils import interop

    cfg = ld.LoopDetectorConfig()
    cap, K = cfg.max_keyframes, cfg.features.max_keypoints
    det = ld.LoopDetector(syn.PinholeIntrinsics(), cfg, device=device)
    pool_mb = det._db_desc.numel() * 4 / 1e6
    n_pre, n_ingest = cap - 64, 256       # 192 ingests past capacity
    rng = np.random.default_rng(9)
    arrays = interop.detector_state_to_numpy(det)
    arrays["db_desc"][:n_pre] = rng.integers(
        0, 2 ** 32, (n_pre, K, 8), dtype=np.uint64).astype(np.uint32)
    arrays["db_valid"][:n_pre] = True
    arrays["db_hdep"][:n_pre] = True
    arrays["db_pcam"][:n_pre] = rng.uniform(
        -2, 2, (n_pre, K, 3)).astype(np.float32)
    arrays["slot_client"][:n_pre] = np.arange(n_pre) % 2
    arrays["slot_t"][:n_pre] = np.arange(n_pre, dtype=np.float64)
    arrays["free"] = np.arange(cap - 1, n_pre - 1, -1)
    for name in ("n_keyframes", "total_keyframes"):
        arrays[name] = np.array(n_pre)
    interop.load_detector_state(det, arrays)
    g = torch.Generator(device=device).manual_seed(9)

    def kp(desc=None, pts=None):
        desc = _words(g, K, device=device) if desc is None else desc
        pts = (torch.rand(K, 3, generator=g, device=device) * 4 - 2
               if pts is None else pts)
        ones = torch.ones(K, dtype=torch.bool, device=device)
        return ft.Keypoints(uv=torch.zeros(K, 2, device=device),
                            response=ones.float(), valid=ones, desc=desc,
                            p_cam=pts, has_depth=ones)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(n_pre, n_pre + n_ingest):
            det.ingest_keypoints(i % 2, float(i), kp())
    torch.cuda.synchronize()
    per_ms = (time.perf_counter() - t0) * 1e3 / n_ingest
    sat = [w for w in rec if "keyframe pool saturated" in str(w.message)]
    per = [sum(k.client_id == c for k in det.keyframes) for c in (0, 1)]
    # one 8-frame sub-batch at capacity: each member takes its own slot,
    # and the pool row of every slot holds the member the table names
    t_b = n_pre + n_ingest
    members = [kp() for _ in range(8)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        det._ingest_keypoints_batch(
            [(i % 2, float(t_b + i)) for i in range(8)],
            ft.Keypoints(*(torch.stack(f) for f in zip(*members))), None)
    where = {(kf.client_id, kf.t): s for s, kf in enumerate(det.slots)}
    for i, m in enumerate(members):
        assert torch.equal(det._db_desc[where[(i % 2, float(t_b + i))]],
                           m.desc), i
    t_end = float(t_b + 8)
    base = kp()
    det.ingest_keypoints(0, t_end, base)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        msgs = det.ingest_keypoints(1, t_end + 1.0, base)
    rev = [m for m in msgs if m.from_time == t_end]
    err = (float(np.linalg.norm(rev[0].T_from_to
                                - np.array([1, 0, 0, 0, 0, 0, 0])))
           if rev else float("nan"))
    print(f"[9] stock detector: pool {cap} x {K} ({pool_mb:.1f} MB of "
          f"descriptors), {n_pre} slots loaded, {n_ingest} ingests at "
          f"{per_ms:.2f} ms each, an 8-member sub-batch at capacity, "
          f"dropped {det.dropped_keyframes}, "
          f"per-client {per}, saturation warnings {len(sat)}, revisit "
          f"messages {len(msgs)} (|T - I| {err:.2e}) — {ident}")
    assert det.n_keyframes == cap and len(det.keyframes) == cap
    assert det.dropped_keyframes == n_pre + n_ingest + 8 + 2 - cap
    assert sat and abs(per[0] - per[1]) <= 1, per
    assert rev and rev[0].from_client == 0 and err < 0.05, msgs


LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def device_us(e) -> float:
    """An event's self device time, µs (the name differs across torch
    versions)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profiled(fn):
    """One call of ``fn`` traced with torch.profiler (CPU and CUDA
    activities), fenced with ``torch.cuda.synchronize()`` → (wall ms,
    summed device ms, kernel launches, key averages, device-side events,
    profiler). Device-side events are kernels, memsets and copies: an aten
    op's self device time repeats the time of the kernels it launched. One
    stream, so they do not overlap and device ms / wall ms is the device
    busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    dev_ms = sum(device_us(e) for e in kernels) / 1e3
    return wall_ms, dev_ms, launches, events, kernels, prof


def print_top(events, kernels, top: int, host: bool = True) -> None:
    """The ``top`` device-side events by device time and, with ``host``,
    the ``top`` events by self host time, of a :func:`profiled` call."""
    print("top device time (self, us):")
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"  {device_us(e):10.1f}  x{e.count:<5d} {e.key[:90]}")
    if host:
        print("top host time (self CPU, us):")
        for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:top]:
            print(f"  {e.self_cpu_time_total:10.1f}  x{e.count:<5d} "
                  f"{e.key[:90]}")


def esdf_record(spec, layer, ident) -> dict:
    """The ESDF build of phase 10's layer through its kernels
    (``esdf_from_tsdf`` on the card) and through the plain sweeps
    (``ops.esdf._esdf_sweeps``), same layer: at the configured 2 m and at
    client_vga's 4 m, ``dist``'s bits and ``observed`` equal in every
    max_blocks row, and 1 + n_iters kernel launches a build. Then at 4 m:
    each back to back (CUDA events), the device time and launches of one
    build (torch.profiler); the bound is each live row's 16³ f32 read and
    written once a sweep at the HBM rate → the record of the ``kernels``
    line."""
    from coxgraph_tpu_torch.ops import esdf as esdf_ops

    v3 = spec.voxels_per_side ** 3
    n_live = int(layer.num_blocks)
    configs = (esdf_ops.EsdfConfig(), esdf_ops.EsdfConfig(max_distance=4.0))
    for ecfg in configs:
        n_iters = esdf_ops.sweep_count(spec, ecfg)
        since = launches_since()
        e = esdf_ops.esdf_from_tsdf(spec, layer, ecfg)
        launches = since("esdf")
        p = esdf_ops._esdf_sweeps(spec, layer, ecfg)
        assert launches == 1 + n_iters, (launches, n_iters)
        assert e.dist.shape == p.dist.shape == (layer.max_blocks, v3)
        assert torch.equal(e.dist.view(torch.int32),
                           p.dist.view(torch.int32)), ecfg
        assert torch.equal(e.observed, p.observed), ecfg
        del e, p
    ecfg = configs[-1]
    n_iters = esdf_ops.sweep_count(spec, ecfg)
    runs = {"kernels": (lambda: esdf_ops.esdf_from_tsdf(spec, layer, ecfg),
                        EVENT_REPS),
            "plain": (lambda: esdf_ops._esdf_sweeps(spec, layer, ecfg), 5)}
    rec = {}
    for name, (fn, reps) in runs.items():
        _, dev_ms, n_launch, _, _, _ = profiled(fn)
        rec[name] = (_time_ms(fn, reps), dev_ms, n_launch)
    assert rec["kernels"][2] == 1 + n_iters, rec["kernels"]
    n_bytes = n_live * 2 * v3 * 4 * n_iters
    bound, by = _bound_ms(n_bytes, 0.0, 1.0)
    print(f"[10] ESDF kernels ≡ plain sweeps ({layer.max_blocks} blocks, "
          f"{n_live} live, 2 m and 4 m: dist's bits, observed, all rows); "
          f"at 4 m ({n_iters} sweeps): kernels {rec['kernels'][0]:.3f} ms "
          f"back to back, device {rec['kernels'][1]:.3f} ms, "
          f"{rec['kernels'][2]:g} launches; plain {rec['plain'][0]:.1f} ms "
          f"back to back, device {rec['plain'][1]:.1f} ms, "
          f"{rec['plain'][2]:g} launches; bound {bound:.3f} ms ({by}: "
          f"{n_live} rows × {2 * v3 * 4} B × {n_iters}) — {ident}")
    return dict(launches=rec["kernels"][2], ms=rec["kernels"][0],
                device_ms=rec["kernels"][1], plain_ms=rec["plain"][0],
                plain_device_ms=rec["plain"][1],
                plain_launches=rec["plain"][2], bound_ms=bound, bound_by=by,
                bound_bytes=n_bytes, live_blocks=n_live,
                max_blocks=layer.max_blocks, sweeps=n_iters,
                max_distance=ecfg.max_distance)


def phase_serving(cfg, device, depths, colors, traj, ident):
    """Phase 10 → (K1's launches on the serving path, the ESDF kernels'
    record)."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import esdf as esdf_ops
    from coxgraph_tpu_torch.ops import merge as merge_ops
    from coxgraph_tpu_torch.ops import mesh as mesh_ops

    spec = cfg.spec
    n = depths.shape[0]
    ts = np.arange(n, dtype=np.float64) * 0.05
    hm = sm.HostMapper(cfg, device=device)
    bounds = np.linspace(0, n, 5).astype(int)

    def window(i):
        lo, hi = bounds[i], bounds[i + 1]
        # no device→host sync may happen on the per-frame path
        torch.cuda.set_sync_debug_mode("error")
        try:
            hm.step_batch(depths[lo:hi], colors[lo:hi], traj[lo:hi],
                          ts[lo:hi])
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def live_equals_full(tag):
        t0 = time.perf_counter()
        v, c = hm.live_mesh(quantize=False)
        live_ms = (time.perf_counter() - t0) * 1e3
        layer = sm.get_layer(hm.state.collection.layers, 0)
        vf, cf = mesh_ops.extract_mesh(spec, layer, quantize=False)
        assert v.shape[0] > 0, tag
        assert np.array_equal(v, vf) and np.array_equal(c, cf), tag
        m = hm.live_mesher(0)
        print(f"[10] {tag}: live_mesh {v.shape[0]} triangles ≡ "
              f"extract_mesh in {live_ms:.1f} ms, chunks re-meshed so far "
              f"{m.chunks_remeshed} (buffer growths {m.buffer_growths}, "
              f"capacity growths {m.capacity_growths})")

    torch.cuda.synchronize()
    since = launches_since()
    window(0)
    live_equals_full("window 1")
    window(1)
    live_equals_full("window 2")
    window(2)
    hm.live_mesh_async(quantize=False)          # finish() never runs
    window(3)
    launches = since("k1")
    live_equals_full("window 4, after a dropped finish()")
    assert launches == n, launches

    layer = sm.get_layer(hm.state.collection.layers, 0)
    ecfg = esdf_ops.EsdfConfig()
    e = esdf_ops.esdf_from_tsdf(spec, layer, ecfg)
    sdf = layer.sdf
    band = e.observed & (sdf.abs() < spec.truncation)
    assert int(band.sum()) > 1000
    assert torch.equal(e.dist[band], sdf[band])
    assert float(e.dist.abs().max()) <= ecfg.max_distance
    beyond = int((e.observed & (e.dist > spec.truncation)).sum())
    assert beyond > 0
    print(f"[10] ESDF: {int(band.sum())} band voxels ≡ the TSDF, "
          f"{beyond} observed voxels beyond the band, |dist| ≤ "
          f"{ecfg.max_distance}")
    del e
    esdf = esdf_record(spec, layer, ident)

    dst_spec = dataclasses.replace(spec, max_blocks=2 * spec.max_blocks)
    dst = vx.create_tsdf_layer(dst_spec, device)
    merge_ops.merge_layer_into_sized(dst_spec, dst, layer,
                                     geo.identity(device), src_spec=spec)
    nb = int(layer.num_blocks)
    d_slot = vx.lookup_block(spec, dst, layer.block_coords[:nb])
    assert bool((d_slot >= 0).all()), "a live source block was dropped"
    got = dst.weight[d_slot.long()]
    src_w = layer.weight[:nb]
    seen = got > 0
    err = (got - src_w).abs()[seen]
    assert int(seen.sum()) > 1000
    assert bool((err <= src_w[seen] * 2.0 ** -8 + 1e-4).all()), float(
        err.max())
    print(f"[10] merge at the identity into {dst_spec.max_blocks} blocks: "
          f"{nb} of {nb} live source blocks kept ({int(dst.num_blocks)} "
          f"allocated), {int(seen.sum())} voxels observed, max |w - "
          f"w_src| {float(err.max()):.3e}")
    del dst

    # the merge destination is built outside the trace, as stage_benchmark
    # keeps it outside merge_ms
    dst = vx.create_tsdf_layer(dst_spec, device)
    pose = geo.identity(device)
    counts = {
        "extract_mesh_device": profiled(lambda: mesh_ops.extract_mesh_device(
            spec, layer, 0.1))[2],
        "esdf_from_tsdf": profiled(lambda: esdf_ops.esdf_from_tsdf(
            spec, layer))[2],
        "merge_layer_into_sized": profiled(
            lambda: merge_ops.merge_layer_into_sized(
                dst_spec, dst, layer, pose, src_spec=spec))[2],
    }
    del dst
    print(f"[10] CUDA kernel launches per call (torch.profiler): {counts}")
    del hm, layer
    torch.cuda.empty_cache()
    out = bm.stage_benchmark(depths, colors, traj)
    print(f"[10] stage_benchmark {json.dumps(out)} — {ident}")
    return launches, esdf


def launches_since():
    """A reading of every kernel's launch count in ``runtime`` → a function
    of a kernel's name giving its launches since the reading."""
    from coxgraph_tpu_torch import runtime

    start = runtime.snapshot()["counters"]
    return lambda name: (runtime.launches(name)
                         - start.get(name + ".launches", 0))


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` →
    (its result, the host syncs torch flagged during it)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def no_sync(fn):
    """``fn()`` with any host sync an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _fenced_ms(fn):
    """(result, wall ms) of one ``fn()`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def pair_alignment_cost(problem, poses) -> float:
    """Σ over the overlapping pairs at ``poses`` of the weighted
    registration cost (tests/test_global_opt_scale.py's measure)."""
    from coxgraph_tpu_torch.ops import registration as reg
    from coxgraph_tpu_torch.server import global_opt as go

    _, _, layers, spec, rcfg, _, _ = problem
    tot = 0.0
    for (i, j) in go.find_overlapping_pairs(spec, layers, poses):
        pts, sdf, m = reg.surface_point_cache(spec, layers[i], rcfg)
        _, _, c, nin = reg.registration_normal_eq(
            spec, layers[j], pts, sdf, m, poses[i], poses[j], 0.1)
        tot += float(c) * 900.0 / max(int(nin), 1)
    return tot


def _pose_errors(a, b):
    """(max translation m, max rotation rad) between pose sets (N,7)."""
    from coxgraph_tpu_torch.core import geometry as geo

    d = geo.relative(a.double(), b.double())
    return (float(geo.translation(a.double() - b.double()).norm(dim=-1)
                  .max()),
            float(geo.so3_log(geo.rotation(d)).norm(dim=-1).max()))


def phase_solve(device, ident, hm):
    """Phase 11: the solve half at the bench solve point, on phase 5's
    stock mapper, and the card's solve against the CPU's."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import registration as reg
    from coxgraph_tpu_torch.server import global_opt as go
    from coxgraph_tpu_torch.solver import pose_graph as pg
    from coxgraph_tpu_torch.utils import interop

    # ---- (a) the bench solve point ----
    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    problem, build_ms = _fenced_ms(bm.solve_benchmark_problem)
    init, cons, layers, spec, rcfg, scfg, fixed = problem
    out = bm.solve_benchmark(problem=problem)
    caches, stack = [None] * len(layers), {}

    def solve(iters=6):
        return go.optimize_two_phase(
            init, cons, spec, layers, reg_cfg=rcfg, solver_cfg=scfg,
            registration_weight=30.0, reg_iterations=iters, fixed=fixed,
            reg_caches=caches, stack_cache=stack)

    solve()
    (poses, info), syncs = count_syncs(solve)
    _, syncs0 = count_syncs(lambda: solve(0))
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    trace = info["phase2_cost_trace"]
    print(f"[11] bench solve point ({out['submaps']} submaps, "
          f"{out['pairs']} pairs, problem built in {build_ms:.1f} ms): "
          f"solve_s {out['solve_s']:.4f}, solve_best_s "
          f"{out['solve_best_s']:.4f}; phase-1 cost {info['phase1_cost']:.3e}"
          f", trace {[round(c, 6) for c in trace]}")
    assert out["pairs"] >= 100 and out["submaps"] == 64, out
    assert info["n_registration_pairs"] == out["pairs"]
    assert len(trace) == 7, trace
    for a, b in zip(trace[:-1], trace[1:]):
        assert b <= a * (1 + 1e-5), trace
    assert bool(torch.isfinite(poses).all())
    c0 = pair_alignment_cost(problem, init)
    c1 = pair_alignment_cost(problem, poses)
    print(f"[11] pair alignment cost {c0:.4f} at the initial poses → "
          f"{c1:.4f}")
    assert c1 < 0.3 * c0, (c0, c1)
    # each phase-2 iteration is sync-free: 6 iterations sync as often
    # as none; the phase-1 LM runs with any sync an error
    assert syncs == syncs0, (syncs, syncs0)
    _, p1_ms = _fenced_ms(lambda: no_sync(lambda: pg.optimize(
        init, cons, scfg, fixed=fixed)))
    _, w6 = _fenced_ms(solve)
    _, w0 = _fenced_ms(lambda: solve(0))

    # launches and device time per LM iteration: differences of short
    # runs (phase 1 alone with 1 and 2 iterations; phase 2 after a
    # 0-iteration phase 1, with 1 and 2 iterations), each traced
    def short(p1_iters, p2_iters=None):
        cfg1 = dataclasses.replace(scfg, iterations=p1_iters)
        if p2_iters is None:
            return lambda: pg.optimize(init, cons, cfg1, fixed=fixed)
        return lambda: go.optimize_two_phase(
            init, cons, spec, layers, reg_cfg=rcfg, solver_cfg=cfg1,
            registration_weight=30.0, reg_iterations=p2_iters, fixed=fixed,
            reg_caches=caches, stack_cache=stack)

    a1, a2 = profiled(short(1)), profiled(short(2))
    b1, b2 = profiled(short(0, 1)), profiled(short(0, 2))
    print(f"[11] phase 1 (pg.optimize, {scfg.iterations} LM iterations, "
          f"sync-free): {p1_ms:.1f} ms, {a2[2] - a1[2]} launches and "
          f"{a2[1] - a1[1]:.2f} ms of device time per iteration; phase 2: "
          f"{(w6 - w0) / 6:.1f} ms per iteration ({w6:.1f} ms with 6, "
          f"{w0:.1f} with 0), {b2[2] - b1[2]} launches and "
          f"{b2[1] - b1[1]:.2f} ms of device time per iteration; host "
          f"syncs per solve {syncs}; peak device memory {peak_mb:.1f} MiB "
          f"above phase 5's mapper — {ident} "
          f"({time.perf_counter() - t_start:.1f} s so far)")

    # ---- (b) phase 5's stock mapper ----
    cfg, st = hm.cfg, hm.state
    col = st.collection
    T_true = col.T_odom_submap[:3].clone()
    pert = geo.se3_exp(torch.tensor([0.01, -0.01, 0.02, 0.05, -0.03, 0.02],
                                    device=device))
    sm.add_loop_closure(st, 0, 2, geo.compose(
        geo.relative(T_true[0], T_true[2]), pert))
    orig = sm.optimize_local

    def strict_local(*a, **k):
        return no_sync(lambda: orig(*a, **k))

    sm.optimize_local = strict_local
    try:
        fin = profiled(hm.finish_map)
    finally:
        sm.optimize_local = orig
    tj = profiled(lambda: sm.trajectory(col))
    stamps, traj = sm.trajectory(col)
    moved = _pose_errors(col.T_odom_submap[:3], T_true)
    print(f"[11] stock mapper: loop closure 0→2 added "
          f"({int(st.constraints.count)} constraints), finish_map "
          f"{fin[0]:.1f} ms profiled, {fin[2]} launches (optimize_local "
          f"sync-free), submaps moved ≤ {moved[0]:.4f} m / {moved[1]:.4f} "
          f"rad; trajectory {tuple(traj.shape)} in {tj[0]:.1f} ms "
          f"profiled, {tj[2]} launches")
    assert not hm.mapping_enabled
    assert stamps.shape == (30,) and traj.shape == (30, 7)
    assert bool(torch.isfinite(traj).all())
    assert stamps.cpu().tolist() == [float(t) for t in range(30)]

    layers3 = [sm.get_layer(col.layers, k) for k in range(3)]
    poses3 = col.T_odom_submap[:3].clone()
    (p3, info3), w3 = _fenced_ms(lambda: go.optimize_two_phase(
        poses3, st.constraints, cfg.spec, layers3))
    l3 = profiled(lambda: go.optimize_two_phase(
        poses3, st.constraints, cfg.spec, layers3))[2]
    tr3 = info3["phase2_cost_trace"]
    print(f"[11] optimize_two_phase over the 3 stock layers "
          f"({info3['n_registration_pairs']} pairs, R = "
          f"{reg.RegistrationConfig().max_reg_blocks}, "
          f"{reg.RegistrationConfig().max_points} points each): {w3:.1f} ms, "
          f"{l3} launches, trace {[round(c, 4) for c in tr3]}")
    assert info3["n_registration_pairs"] >= 1
    for a, b in zip(tr3[:-1], tr3[1:]):
        assert b <= a * (1 + 1e-5), tr3
    assert bool(torch.isfinite(p3).all())

    T01 = geo.relative(T_true[0], T_true[1])
    chk, wc = _fenced_ms(lambda: go.check_loop_closure_candidates(
        cfg.spec, layers3, [(0, 1, T01)]))
    lc = profiled(lambda: go.check_loop_closure_candidates(
        cfg.spec, layers3, [(0, 1, T01)]))[2]
    print(f"[11] check_loop_closure_candidates (0, 1): {chk[0]} in "
          f"{wc:.1f} ms, {lc} launches")
    assert chk[0]["n_inliers"] > 0 and np.isfinite(chk[0]["rms"])

    # test_registration.py's perturbation. At the stock spec it lies
    # beyond register_pair's basin: the reference itself (JAX, CPU, on
    # these layers) walks 0.096 → 0.594 while its cost falls (ROADMAP
    # queue 3), so the pose error is printed, not gated. Its end lies in
    # a flat false minimum, where the card's and the CPU's f32 runs part
    # by ~1e-2; the card is held to the CPU instead on the normal
    # equations at the start (1e-4 of their max, n_valid exact).
    T_init = geo.compose(T01, geo.se3_exp(torch.tensor(
        [0.02, -0.015, 0.03, 0.06, -0.04, 0.05], device=device)))
    rp, wr = _fenced_ms(lambda: no_sync(lambda: reg.register_pair(
        cfg.spec, layers3[0], layers3[1], T_init)))
    lr = profiled(lambda: reg.register_pair(cfg.spec, layers3[0],
                                            layers3[1], T_init))[2]
    e0 = float(geo.se3_log(geo.relative(T_init, T01)).norm())
    e1 = float(geo.se3_log(geo.relative(rp.T_A_B, T01)).norm())
    rcfg0 = reg.RegistrationConfig()
    eqs = []
    for la, lb in (layers3[:2], [interop.layer_from_numpy(
            interop.layer_to_numpy(l), torch.device("cpu"))
            for l in layers3[:2]]):
        cache = reg.surface_point_cache(cfg.spec, la, rcfg0)
        eqs.append(reg.registration_normal_eq(
            cfg.spec, lb, *cache, geo.identity(la.sdf.device),
            T_init.to(la.sdf.device), rcfg0.huber_delta))
    (Hg, bg, _, ng), (Hc, bc, _, nc) = eqs
    dH = float((Hg.cpu() - Hc).abs().max() / Hc.abs().max())
    db = float((bg.cpu() - bc).abs().max() / bc.abs().max())
    print(f"[11] ({time.perf_counter() - t_start:.1f} s so far) "
          f"register_pair(0, 1) at the stock spec (sync-free): cost "
          f"{float(rp.initial_cost):.4f} → {float(rp.cost):.4f}, "
          f"{int(rp.n_inliers)} inliers, pose error {e0:.4f} → {e1:.4f} "
          f"(the reference's own outcome), {wr:.1f} ms, {lr} launches; "
          f"normal equations at the start, card vs CPU: H {dH:.1e}, b "
          f"{db:.1e} of their max, n_valid {int(ng)} / {int(nc)}")
    assert float(rp.cost) < float(rp.initial_cost)
    assert int(rp.n_inliers) > 200
    assert int(ng) == int(nc) > 200 and dH <= 1e-4 and db <= 1e-4
    del eqs
    del layers3

    # ---- (c) the card's solve ≡ the CPU's, 8 submaps ----
    res = {}
    for dev in (device, torch.device("cpu")):
        pr = bm.solve_benchmark_problem(8, device=dev)
        res[dev.type] = go.optimize_two_phase(
            pr[0], pr[1], pr[3], pr[2], reg_cfg=pr[4], solver_cfg=pr[5],
            registration_weight=30.0, reg_iterations=6, fixed=pr[6])
    (pg_, ig), (pc, ic) = res["cuda"], res["cpu"]
    dt, dr = _pose_errors(pg_.cpu(), pc)
    tg, tc = np.array(ig["phase2_cost_trace"]), np.array(
        ic["phase2_cost_trace"])
    rel = float(np.abs(tg - tc).max() / np.abs(tc).max())
    print(f"[11] ({time.perf_counter() - t_start:.1f} s) 8 submaps, "
          f"card vs CPU: {ig['n_registration_pairs']} / "
          f"{ic['n_registration_pairs']} pairs, poses ≤ {dt:.2e} m / "
          f"{dr:.2e} rad, trace rel {rel:.2e}")
    assert ig["n_registration_pairs"] == ic["n_registration_pairs"]
    assert dt <= 1e-4 and dr <= 1e-4 and rel <= 1e-4, (dt, dr, rel)
    return out


def _online_graph(server):
    """Host copies of the server's online graph: T_G_cli, every
    T_G_submap, the constraint pool and its kinds."""
    return ({c: T.copy() for c, T in server.T_G_cli.items()},
            [s.T_G_submap.copy() for s in server.submaps],
            {k: v.copy() for k, v in server._cons.fields.items()},
            server._cons.count, list(server.constraint_kinds))


def _same_graph(a, b) -> bool:
    return (a[0].keys() == b[0].keys()
            and all(np.array_equal(a[0][c], b[0][c]) for c in a[0])
            and len(a[1]) == len(b[1])
            and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
            and all(np.array_equal(a[2][k], b[2][k]) for k in a[2])
            and a[3] == b[3] and a[4] == b[4])


def small_world_card_vs_cpu(device, height: float = 0.0, **cfg_kw):
    """tests/test_server.py's two-client world (orbits raised by
    ``height``), built by the port on the CPU and carried to the card with
    utils.interop; two fusions through a server (ServerConfig with
    ``cfg_kw``) on each → (the largest translation m and rotation rad
    difference of T_G_cli and the submap poses, the first solve's phase-2
    starting cost on the card and on the CPU, or None without phase 2)."""
    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.server import fusion_server as fs
    from coxgraph_tpu_torch.server.client_interface import InProcessClient
    from coxgraph_tpu_torch.utils import interop

    trajs, _, cpu_clients = demos.small_two_client_world("cpu", height)
    cfg, scfg = demos.small_world_configs()
    scfg = dataclasses.replace(scfg, **cfg_kw)
    card_clients = [InProcessClient(c.client_id, cfg,
                                    interop.mapper_state_from(c.state,
                                                              device))
                    for c in cpu_clients]
    servers = [fs.CoxgraphServer(scfg, cpu_clients, "cpu"),
               fs.CoxgraphServer(scfg, card_clients, device)]
    for ta, tb in ((3, 3), (6, 5)):
        for s in servers:
            assert s.map_fusion(demos.true_fusion(trajs, ta, tb))
    cpu, card = servers
    assert card.cli_ser == cpu.cli_ser
    assert card.constraint_kinds == cpu.constraint_kinds
    assert not card.optimize_errors and not cpu.optimize_errors

    def stack(s):
        return torch.from_numpy(np.stack(
            [s.T_G_cli[c] for c in sorted(s.T_G_cli)]
            + [m.T_G_submap for m in s.submaps]))

    start = [s.fusion_log[0].get("phase2_cost_trace", [None])[0]
             for s in (card, cpu)]
    return (*_pose_errors(stack(card), stack(cpu)), *start)


def phase_two_robot(device, ident):
    """Phase 12: the collaborative server tier through the port of
    examples/two_robot_demo.py at the demo's own operating point → the
    demo's server (phase 14 meshes it once more)."""
    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.frontends import synthetic as syn
    from coxgraph_tpu_torch.server import fusion_server as fs
    from coxgraph_tpu_torch.utils.tensorops import upload

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    demo = demos.TwoRobotDemo(device)
    server = demo.server
    since = launches_since()
    res = demo.stream()
    k1, k2 = since("k1"), since("k2")
    frames = sum(int(c.state.frame_count) for c in demo.clients)
    walls = res["solve_walls"]
    print(f"[12] streamed {res['frames']} frames in {res['stream_s']:.2f} s "
          f"({res['fps']:.2f} frames/s); {res['fusions']} fusions accepted, "
          f"{res['solves']} solves, {res['coalesced_solves']} coalesced; "
          f"{res['server_submaps']} server submaps — {ident}")
    print(f"[12] solve wall per optimize min / median / max "
          f"{min(walls or [0]):.4f} / {float(np.median(walls or [0])):.4f} "
          f"/ {max(walls or [0]):.4f} s; {res['solve_s']:.2f} s of solve, "
          f"{res['fusion_dispatch_s']:.2f} s charged to the stream, "
          f"{res['overlap_s']:.2f} s overlapped with streaming "
          f"(share {res['overlap_share']:.3f}); client-1 frame alignment "
          f"error rot {res['align_rot']:.4f} rad, trans "
          f"{res['align_trans']:.4f} m — {ident}")
    print(f"[12] K1 launches {k1} for {frames} integrated frames, K2 "
          f"launches {k2}")
    assert k1 == frames == res["frames"], (k1, frames)
    assert k2 >= 1, k2

    before = _online_graph(server)
    res.update(demo.finish())
    isolated = _same_graph(before, _online_graph(server))
    print(f"[12] get_final_global_mesh (isolated, 6,144-block merge) "
          f"{res['final_mesh_s']:.2f} s: {res['triangles']} triangles, "
          f"surface error p50 {res['surf_p50'] * 100:.2f} cm p90 "
          f"{res['surf_p90'] * 100:.2f} cm; ATE {res['ate'][0] * 100:.2f} / "
          f"{res['ate'][1] * 100:.2f} cm; {res['bytes_shipped'] / 1e6:.1f} "
          f"MB of submaps shipped; online graph unchanged: {isolated} — "
          f"{ident}")
    assert res["fusions"] >= 1 and not res["optimize_errors"], res
    assert max(res["ate"]) < demos.ATE_GATE, res["ate"]
    assert res["triangles"] > 1000, res["triangles"]
    assert res["surf_p90"] < demos.SURFACE_GATE * demo.cfg.spec.voxel_size
    assert isolated, "the isolated final mesh changed the online graph"
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30

    # one more solve on the online graph, no solve in flight: its host
    # syncs, launches and device busy share
    _, opt_syncs = count_syncs(server.optimize)
    o_wall, o_dev, o_launch, *_ = profiled(server.optimize)
    # one more frame of robot 0 (rendered outside the trace)
    t = demo.frames * demos.DT
    T_w = demo.trajs[0][-1]
    depth, color = syn.render_depth(demo.scene, demo.cfg.intrinsics,
                                    upload(T_w, device))
    f_wall, f_dev, f_launch, *_ = profiled(
        lambda: demo.vios[0].update_pose(demo.odoms[0][-1], t, depth, color))
    print(f"[12] one optimize: {opt_syncs} host syncs; traced "
          f"{o_wall:.1f} ms wall, {o_dev:.2f} ms device (busy "
          f"{o_dev / o_wall:.3f}), {o_launch} launches; one frame through "
          f"VIOInterface: {f_wall:.2f} ms wall, {f_dev:.3f} ms device (busy "
          f"{f_dev / f_wall:.3f}), {f_launch} launches; peak device memory "
          f"{peak:.2f} GiB above the phase's start — {ident}")

    # a fusion with the solve off: the first pulls its two submaps from
    # the clients, the second is served from the held submaps
    probe = fs.CoxgraphServer(
        dataclasses.replace(server.cfg, refuse_interval=0.0,
                            async_pgo=False), demo.clients, device)
    probe.control_trigger(False)
    mf = demo.accepted[0]
    ok1, pull_syncs = count_syncs(lambda: probe.map_fusion(mf))
    ok2, fusion_syncs = count_syncs(lambda: probe.map_fusion(mf))
    print(f"[12] control-off fusion: {pull_syncs} host syncs pulling its "
          f"submaps, {fusion_syncs} on held submaps")
    assert ok1 and ok2 and fusion_syncs == 0, (ok1, ok2, fusion_syncs)
    del probe, demo
    torch.cuda.empty_cache()

    # the server's optimize, card vs CPU, on tests/test_server.py's world:
    # its level orbits put registration samples on the voxel lattice, so
    # the full solve is held without registration, and with it on the
    # same world with the orbits raised 0.3 m; the level full solve's
    # difference is printed (ROADMAP queue 3)
    errs = {"level, registration weight 0":
            small_world_card_vs_cpu(device, registration_weight=0.0),
            "orbits raised 0.3 m": small_world_card_vs_cpu(device, 0.3),
            "level (not gated)": small_world_card_vs_cpu(device)}
    print("[12] server optimize, card vs CPU on the small two-client world: "
          + "; ".join(f"{k} {e[0]:.3e} m / {e[1]:.3e} rad"
                      + ("" if e[2] is None else
                         f" (first phase-2 start cost card {e[2]:.6f}, "
                         f"CPU {e[3]:.6f})")
                      for k, e in errs.items())
          + f"; phase 12 took {time.perf_counter() - t_phase:.1f} s")
    for key in ("level, registration weight 0", "orbits raised 0.3 m"):
        dt, dr = errs[key][:2]
        assert dt <= 1e-4 and dr <= 1e-4, (key, dt, dr)
    return server


def phase_distributed(device, ident):
    """Phase 13: the distributed deployment at the two-robot demo's point
    (robot processes on the card, the native bus, mesh with history), K1
    against its twin at this path's shapes, and the point-cloud path → K1's
    largest difference from its twin there."""
    from coxgraph_tpu_torch.comm import mesh_comm
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.frontends import replay
    from coxgraph_tpu_torch.frontends import synthetic as syn
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import points as pts_ops
    from coxgraph_tpu_torch.utils.tensorops import upload

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    since = launches_since()
    res = demos.distributed_demo(device)
    k1_parent = since("k1")
    robots = res["robots"]
    for cid, r in enumerate(robots):
        print(f"[13] robot process {cid}: {r['frames']} frames at "
              f"{r['fps']:.2f} frames/s (render, HostMapper.step, serving), "
              f"K1 launches {r['k1_launches']}, {r['n_submaps']} submaps, "
              f"peak device memory {r['peak_bytes'] / 2**30:.2f} GiB — "
              f"{ident}")
    print(f"[13] robots up (spawn, import, CUDA) {res['robots_up_s']:.2f} s; "
          f"fusion at mid-run: dispatch {res['fusion_dispatch_s']:.3f} s, "
          f"fusion to solution {res['fusion_to_solution_s']:.3f} s; stream "
          f"to finish_map {res['stream_s']:.2f} s; client-frame error "
          f"{res['align_err']:.4f} — {ident}")
    print(f"[13] {res['server_submaps']} server submaps: "
          f"{res['bytes_per_submap'] / 1e6:.3f} MB shipped per submap, "
          f"{res['wire_ratio']:.4f} of the live rows' raw bytes; pull "
          f"{res['pull_per_submap_ms']:.1f} ms per submap; "
          f"get_submap_by_time round trip {res['submap_round_trip_ms']:.1f}"
          f" ms; pulled ≡ robots' copies: sdf within "
          f"{res['pulled_sdf_err']:.3e} m, weights within "
          f"{res['pulled_weight_rel_err']:.3e}·(1+w) — {ident}")
    print(f"[13] final global mesh {res['final_mesh_s']:.2f} s, "
          f"{res['triangles']} triangles; {res['pose_rows']} pose rows; "
          f"server peak device memory "
          f"{(res['peak_bytes'] - mem0) / 2**30:.2f} GiB above the phase's "
          f"start — {ident}")
    rec = res["recovered"]

    def spread(vals):
        vals = sorted(vals)
        return (f"{vals[0]:.1f} / {float(np.median(vals)):.1f} / "
                f"{vals[-1]:.1f}")

    print(f"[13] mesh with history, {len(rec)} submaps (min / median / "
          f"max): encode {spread(res['encode_ms'])} ms (robot side), "
          f"decode {spread([r['decode_ms'] for r in rec])} ms, recover "
          f"projective {spread([r['projective_ms'] for r in rec])} ms, "
          f"merged {spread([r['merged_ms'] for r in rec])} ms; message "
          f"{spread([r['bytes'] / 1e3 for r in rec])} kB, "
          f"{spread([100 * r['bytes'] / r['voxel_bytes'] for r in rec])}% "
          f"of the voxel wire; p90 |SDF| projective "
          f"{max(r['projective_p90'] for r in rec) * 100:.2f} cm, merged "
          f"{max(r['merged_p90'] for r in rec) * 100:.2f} cm (worst); "
          f"combined {res['combined_mesh_faces']} faces in "
          f"{res['combined_mesh_ms']:.1f} ms; K1 launches in this process "
          f"{k1_parent} — {ident}")
    failed = [k for k, ok in res["gates"].items() if not ok]
    assert not failed, (failed, res["gates"])
    assert res["ok"] and set(res["gates"]) >= {
        "fusion_accepted", "alignment", "triangles", "pose_history",
        "k1_per_frame", "pulled_equals_robots", "mesh_with_history"}

    # K1 ≡ its twin at this path's shapes (the demo's 1,024 lanes): the
    # first two frames of robot 0's clip, and the recovered keyframe of
    # most points, splatted by render_points, at the recovery's constant
    # weights
    dcfg = res["config"]
    replays, _, _ = replay.two_robot_experiment(
        n_frames=res["frames"], intr=dcfg.intrinsics, dt=demos.DT,
        device=device)
    clip = iter(replays[0])
    robot_frames = []
    for _ in range(2):
        f = next(clip)
        robot_frames.append((0, f.depth, f.color.permute(2, 0, 1)
                             .contiguous(), upload(f.T_odom_cam, device)))
    k1_err, _ = k1_against_twin(dcfg, device, robot_frames, "13 robot")
    msg = res["sample_mesh"]
    clouds = mesh_comm.decode_to_pointclouds(msg, dcfg.spec.voxel_size)
    kf = max(clouds, key=lambda i: clouds[i][0].shape[0])
    depth, color = mesh_comm.render_points(
        dcfg.intrinsics, upload(clouds[kf][0], device),
        upload(clouds[kf][1], device))
    err, _ = k1_against_twin(
        dcfg, device, [(0, depth, color.permute(2, 0, 1).contiguous(),
                        upload(msg.kf_poses[kf], device))],
        "13 recovered keyframe", icfg=dataclasses.replace(
            dcfg.integrator, use_distance_weight=False))
    k1_err = max(k1_err, err)
    torch.cuda.empty_cache()

    # (c) point clouds: examples/pointcloud_demo.py at its own point
    pc = demos.pointcloud_demo(device)
    print(f"[13] point-cloud demo: {pc['clouds']} clouds of "
          f"{pc['points_per_cloud']} points in {pc['integrate_s']:.2f} s, "
          f"{pc['submaps']} submaps, {pc['triangles']} triangles, surface "
          f"p90 {pc['surf_p90'] * 100:.2f} cm — {ident}")
    assert pc["ok"], pc
    cfg = bm._mapper_config()
    hm = sm.HostMapper(cfg, device=device)
    scene = syn.default_scene(device)
    T = syn.orbit_trajectory(1, scene.room_center, radius=2.4)[0]
    times = {}
    for scale in (0.25, 1.0):
        intr = syn.PinholeIntrinsics().scaled(scale)
        depth, color = syn.render_depth(scene, intr, T)
        p = pts_ops.backproject(intr, depth).reshape(-1, 3)
        c = color.reshape(-1, 3)
        m = depth.reshape(-1) > 0.1
        T_np = T.cpu().numpy()
        for i in range(2):                                  # warm-up
            hm.step_points(p, c, m, T_np, 0.01 * i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            hm.step_points(p, c, m, T_np, 0.1 + 0.01 * i)
        torch.cuda.synchronize()
        times[p.shape[0]] = (time.perf_counter() - t0) * 100.0
    print("[13] HostMapper.step_points at the bench spec: "
          + ", ".join(f"{n} points {ms:.2f} ms" for n, ms in times.items())
          + f" — {ident}; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    del hm
    torch.cuda.empty_cache()
    return k1_err


FLEET_ROBOTS = 8               # phase 14: robots at the bench point
FLEET_FRAMES = 30              # frames a robot
FLEET_DT = 0.05                # s between frames
FLEET_INTERVAL = 0.5           # s: submaps open at t = 0, 0.5 and 1.0
DRYRUN_ROBOTS = 8              # the dry run's own point (eval.dryrun)


def _state_diff(a, b):
    """(integer fields that differ, float fields' max |Δ|, live voxels
    differing by more than 1e-5, live voxels) between two MapperStates."""
    from coxgraph_tpu_torch.utils import interop

    fa, fb = interop.flatten(a), interop.flatten(b)
    bad_int, max_d, n_big = [], 0.0, 0
    for k, x in fa.items():
        y = fb[k]
        if x.is_floating_point():
            d = (x - y).abs()
            max_d = max(max_d, float(d.max()))
            if k.startswith("collection.layers."):
                n_big += int((d > 1e-5).sum())
        elif not torch.equal(x, y):
            bad_int.append(k)
    return bad_int, max_d, n_big, int((a.collection.layers.weight > 0).sum())


def _merge_gates(a, b):
    """test_merge_sharded.py's gates between two fused layers on the blocks
    both allocated → (max |Δw|, max |Δsdf|, max |Δcolour|) on the voxels
    both observe; asserts the gates (1e-5, 1e-4, 2e-2)."""
    ia, ib = a.block_index.reshape(-1), b.block_index.reshape(-1)
    sel = (ia >= 0) & (ib >= 0)
    sa, sb = ia[sel].long(), ib[sel].long()
    wa, wb = a.weight[sa], b.weight[sb]
    live = wb > 1e-6
    dw = float((wa - wb).abs().max())
    ds = float((a.sdf[sa] - b.sdf[sb]).abs()[live].max())
    dc = float((a.color[sa] - b.color[sb]).abs()[live.repeat(1, 3)].max())
    assert dw <= 1e-5 and ds <= 1e-4 and dc <= 2e-2, (dw, ds, dc)
    assert abs(float(wa.sum()) - float(a.weight.sum())) <= 1e-6 * float(
        a.weight.sum()) + 1e-3
    return dw, ds, dc


def _matched_triangles(a, b, atol: float) -> int:
    """Triangles of soup ``a`` (T,3,3) that have their own triangle in
    ``b`` with every coordinate within ``atol``."""
    from scipy.spatial import cKDTree

    d, idx = cKDTree(b.reshape(len(b), -1)).query(a.reshape(len(a), -1),
                                                   p=np.inf)
    ok = d <= atol
    return int(min(ok.sum(), len(np.unique(idx[ok]))))


def deterministic_dryrun(n: int, device, mesh=None):
    """eval.dryrun.dryrun_multichip(n) under
    ``torch.use_deterministic_algorithms(True)`` (phase 14 runs it here
    and in spawned ranks)."""
    from coxgraph_tpu_torch.eval import dryrun

    torch.use_deterministic_algorithms(True)
    try:
        return dryrun.dryrun_multichip(n, device, mesh)
    finally:
        torch.use_deterministic_algorithms(False)


def phase_parallel(device, ident, server):
    """Phase 14: the parallel tier (parallel/, eval.dryrun) on a world-size-1
    NCCL group: the 8-robot fleet at the bench point, fleet_optimize, the
    sharded ESDF, the sharded merge and mesh, the dry run over two gloo
    ranks on the card, and phase 12's server's sharded final mesh → (K1
    launches on the fleet path, K1's largest difference from its twin at
    the fleet's shapes)."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.eval import dryrun
    from coxgraph_tpu_torch.frontends import synthetic as syn
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import esdf as esdf_ops
    from coxgraph_tpu_torch.ops import merge as merge_ops
    from coxgraph_tpu_torch.ops import mesh as mesh_ops
    from coxgraph_tpu_torch.parallel import esdf_sharded as es
    from coxgraph_tpu_torch.parallel import fleet as fl
    from coxgraph_tpu_torch.parallel import merge_sharded as msh
    from coxgraph_tpu_torch.parallel import multihost
    from coxgraph_tpu_torch.solver import pose_graph as pg
    from coxgraph_tpu_torch.utils.tensorops import upload

    t_phase = time.perf_counter()
    R, F = FLEET_ROBOTS, FLEET_FRAMES
    cfg = dataclasses.replace(bm._mapper_config(),
                              submap_interval=FLEET_INTERVAL)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # each robot orbits its own sector of the room, rendered on the card
    scene = syn.default_scene(device)
    traj = torch.stack([syn.orbit_trajectory(
        F, scene.room_center, radius=2.5, sweep=2 * np.pi / R,
        start_angle=2 * np.pi * r / R) for r in range(R)], 1)  # (F,R,7)
    frames = [syn.render_depth(scene, cfg.intrinsics, traj[f, r])
              for f in range(F) for r in range(R)]
    depths = torch.stack([d for d, _ in frames]).reshape(
        F, R, *frames[0][0].shape)
    colors = torch.stack([c for _, c in frames]).reshape(
        F, R, *frames[0][1].shape)
    del frames
    ts = [torch.full((R,), FLEET_DT * f, device=device) for f in range(F)]

    with multihost.single_process(device):
        mesh = fl.make_robot_mesh(R, device)
        print(f"[14] world-size-1 {torch.distributed.get_backend()} group "
              f"on {device}; {R} robots × {F} frames at "
              f"{cfg.intrinsics.width}×{cfg.intrinsics.height}, "
              f"{cfg.max_submaps} submaps × {cfg.spec.max_blocks} blocks a "
              f"robot, submap interval {FLEET_INTERVAL} s")

        # ---- (1) the fleet at the bench point, sync-free ----------------
        fleet = fl.shard_fleet(fl.create_fleet(cfg, R, device), mesh)
        pool_gb = sum(sum(t.numel() * t.element_size() for t in (
            st.collection.layers.sdf, st.collection.layers.weight,
            st.collection.layers.color)) for st in fleet.states) / 1e9
        torch.cuda.synchronize()
        since = launches_since()
        t0 = time.perf_counter()
        no_sync(lambda: [fl.fleet_step(cfg, mesh, fleet, depths[f],
                                       colors[f], traj[f], ts[f])
                         for f in range(F)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fleet_launches = since("k1")
        nsub = [int(st.collection.num_submaps) for st in fleet.states]
        nblk = [st.collection.layers.num_blocks.tolist()
                for st in fleet.states]
        print(f"[14] fleet_step × {F}: {R * F} robot frames in "
              f"{wall:.3f} s ({R * F / wall:.1f} frames/s, first call, "
              f"under sync-debug error), K1 launches {fleet_launches}, "
              f"submaps {nsub}, blocks per submap {nblk}, pools "
              f"{pool_gb:.2f} GB — {ident}")
        assert fleet_launches == R * F, fleet_launches
        assert nsub == [3] * R, nsub
        # each robot ≡ the same robot alone through mapper_step
        worst = (0.0, 0)
        for r in range(R):
            st = sm.create_mapper(cfg, device)
            for f in range(F):
                sm.mapper_step(cfg, st, depths[f, r], colors[f, r],
                               traj[f, r], FLEET_DT * f)
            bad, max_d, n_big, n_live = _state_diff(fleet.states[r], st)
            assert not bad, (r, bad)
            assert n_big <= 1e-3 * n_live, (r, n_big, n_live)
            worst = max(worst, (max_d, n_big))
            del st
        print(f"[14] each robot ≡ its mapper_step run alone: integers "
              f"equal, max |Δ| {worst[0]:.3e}, live voxels > 1e-5 apart "
              f"{worst[1]}")
        # K1 kernels on the trace of a fleet step (a fresh fleet's first),
        # and K1 ≡ its twin at the fleet's shapes (robot 0's first frames)
        fresh = fl.shard_fleet(fl.create_fleet(cfg, R, device), mesh)
        step_kernels = profiled(lambda: fl.fleet_step(
            cfg, mesh, fresh, depths[0], colors[0], traj[0], ts[0]))[4]
        k1_traced = sum(e.count for e in step_kernels
                        if "tsdf_update_blocks" in e.key)
        del fresh
        print(f"[14] a fleet step traced (torch.profiler): {k1_traced} K1 "
              f"kernels")
        assert k1_traced == R, k1_traced
        planar = colors[:2, 0].permute(0, 3, 1, 2).contiguous()
        k1_err, _ = k1_against_twin(cfg, device, [
            (0, depths[f, 0], planar[f],
             geo.relative(traj[0, 0], traj[f, 0])) for f in range(2)],
            "14 fleet")

        # ---- (2) fleet_optimize with drifted submap poses ----------------
        S = cfg.max_submaps
        true = torch.stack([st.collection.T_odom_submap.clone()
                            for st in fleet.states])            # (R,S,7)
        rng = np.random.default_rng(11)
        noise = rng.normal(0, [0.01] * 3 + [0.03] * 3, (R, S, 6))
        noise[0, 0] = 0.0                                       # the gauge
        drifted = geo.compose(true, geo.se3_exp(upload(
            noise.astype(np.float32), device)))
        for r, st in enumerate(fleet.states):
            st.collection.T_odom_submap.copy_(drifted[r])
        inter = pg.RelPoseConstraints.empty(2 * R + 4, device)
        eye = 10.0 * torch.eye(6, device=device)
        for r in range(R):
            inter = inter.add(r * S, r * S + 2, geo.relative(
                true[r, 0], true[r, 2]), eye)
        for r in range(R - 1):
            inter = inter.add(r * S, (r + 1) * S, geo.relative(
                true[r, 0], true[r + 1, 0]), eye)
        scfg = pg.SolverConfig(iterations=10)
        live = torch.zeros((R, S), dtype=torch.bool, device=device)
        live[:, :3] = True
        err0 = _pose_errors(drifted[live], true[live])
        comm = multihost.fleet_optimize_comm_bytes(cfg, mesh, fleet, inter,
                                                   scfg)
        ici = fl.ici_bytes_per_optimize(cfg, R, scfg)
        syncs = {}
        for iters in (0, scfg.iterations):
            _, syncs[iters] = count_syncs(lambda: fl.fleet_optimize(
                cfg, mesh, fleet, inter,
                dataclasses.replace(scfg, iterations=iters)))
            for r, st in enumerate(fleet.states):
                st.collection.T_odom_submap.copy_(drifted[r])
        (_, poses), opt_ms = _fenced_ms(lambda: fl.fleet_optimize(
            cfg, mesh, fleet, inter, scfg))
        got = poses.reshape(R, S, 7)
        err1 = _pose_errors(got[live], true[live])
        # the same problem on the CPU, a gloo world-1 group beside NCCL's
        cpu = torch.device("cpu")
        cmesh = fl.make_robot_mesh(R, cpu, torch.distributed.new_group(
            backend="gloo"))
        cfleet = fl.Fleet([fl._moved(dataclasses.replace(
            st, collection=dataclasses.replace(
                st.collection, T_odom_submap=drifted[r])), cpu)
            for r, st in enumerate(fleet.states)], 0, R)
        _, cposes = fl.fleet_optimize(cfg, cmesh, cfleet, fl._moved(
            inter, cpu), scfg)
        dcpu = _pose_errors(poses.cpu(), cposes)
        print(f"[14] fleet_optimize ({R * S} poses, {scfg.iterations} LM "
              f"iterations): pose error to the truth {err0[0]:.4f} m / "
              f"{err0[1]:.4f} rad → {err1[0]:.2e} m / {err1[1]:.2e} rad in "
              f"{opt_ms:.1f} ms; host syncs {syncs[0]} with 0 iterations, "
              f"{syncs[scfg.iterations]} with {scfg.iterations}; card ≡ CPU "
              f"within {dcpu[0]:.2e} m / {dcpu[1]:.2e} rad; collective bytes "
              f"counted {comm} vs ici_bytes_per_optimize {ici} — {ident}")
        assert err1[0] < err0[0] and err1[1] < err0[1], (err0, err1)
        assert syncs[scfg.iterations] == syncs[0], syncs
        assert dcpu[0] <= 1e-4 and dcpu[1] <= 1e-4, dcpu
        assert comm["per_iteration"] == {
            "all_reduce": ici["per_iteration_bytes"] - 4,
            "all_gather": 4 * R}, comm
        del cfleet, cmesh

        # ---- (3) the sharded ESDF ≡ the single-device ESDF ---------------
        spec = cfg.spec
        layer = sm.get_layer(fleet.states[0].collection.layers, 0)
        sphere_spec = dataclasses.replace(dryrun.dryrun_config().spec,
                                          max_blocks=640)
        sphere = dryrun.sphere_layer(sphere_spec, device)
        for tag, sp, la, ecfg in (
                ("robot 0's submap 0", spec, layer, esdf_ops.EsdfConfig()),
                ("the dry run's sphere", sphere_spec, sphere,
                 esdf_ops.EsdfConfig(max_distance=1.5))):
            D = R
            cfg_d = es.fitted_config(sp, la, D, ecfg)
            (parts, part_ms) = _fenced_ms(
                lambda: es.partition_blocks(sp, la, D, cfg_d))
            d_sh, sh_ms = _fenced_ms(
                lambda: es.esdf_sharded(sp, mesh, parts, cfg_d))
            ref, ref_ms = _fenced_ms(
                lambda: esdf_ops.esdf_from_tsdf(sp, la, ecfg))
            got = es.gather_to_layer(sp, la, parts, d_sh, mesh)
            n = int(la.num_blocks)
            same = torch.equal(got.dist[:n], ref.dist[:n])
            print(f"[14] sharded ESDF of {tag} ({n} blocks, {D} slabs of "
                  f"{cfg_d.per_device_blocks} + 2 × {cfg_d.halo_blocks} "
                  f"halo): {sh_ms:.1f} ms (partition on the host "
                  f"{part_ms:.1f} ms) vs esdf_from_tsdf {ref_ms:.1f} ms; "
                  f"bit-identical {same} — {ident}")
            assert same, tag
        del layer, sphere, parts, d_sh, ref, got

        # ---- (4) the sharded merge and mesh of the fleet's submaps -------
        dspec = dataclasses.replace(spec, max_blocks=2 * spec.max_blocks)
        layers = [vx.TsdfLayer(**{f.name: getattr(
            st.collection.layers, f.name)[k] for f in dataclasses.fields(
                vx.TsdfLayer)}) for st in fleet.states for k in range(3)]
        mposes = [st.collection.T_odom_submap[k] for st in fleet.states
                  for k in range(3)]
        fused, sh_ms = _fenced_ms(lambda: msh.merge_layers_sharded(
            dspec, mesh, layers, mposes, src_spec=spec,
            max_touched=dspec.max_blocks))

        def sequential():
            dst = vx.create_tsdf_layer(dspec, device)
            for la, T in zip(layers, mposes):
                merge_ops.merge_layer_into(dspec, dst, la, T,
                                           dspec.max_blocks, src_spec=spec)
            return dst
        seq, seq_ms = _fenced_ms(sequential)
        gates = _merge_gates(fused, seq)
        (v, c), msh_ms = _fenced_ms(lambda: msh.extract_mesh_sharded(
            dspec, mesh, fused, min_weight=0.1,
            max_tris_per_device=2_000_000))
        (vs, cs), ms_ms = _fenced_ms(lambda: mesh_ops.extract_mesh(
            dspec, fused, min_weight=0.1, quantize=False))
        print(f"[14] sharded merge of the fleet's {len(layers)} submaps into "
              f"{dspec.max_blocks} blocks ({int(fused.num_blocks)} "
              f"allocated): {sh_ms:.1f} ms vs the merge_layer_into loop "
              f"{seq_ms:.1f} ms; max |Δ| weight {gates[0]:.2e}, sdf "
              f"{gates[1]:.2e}, colour {gates[2]:.2e}; sharded mesh "
              f"{v.shape[0]} triangles in {msh_ms:.1f} ms vs "
              f"extract_mesh(quantize=False) {ms_ms:.1f} ms — {ident}")
        assert v.shape[0] > 1000
        assert np.array_equal(v, vs) and np.array_equal(c, cs)
        del layers, fused, seq, v, c, vs, cs
        fleet_states = fleet.states
        del fleet
        torch.cuda.empty_cache()

        # ---- (6) phase 12's server: its final mesh, sharded ---------------
        server.control_trigger(False)          # no solve: the same poses
        ms_spec = server._auto_merge_spec(server.cfg.spec,
                                          [s.layer for s in server.submaps])
        (m_sh, v_sh, c_sh), t_sh = _fenced_ms(
            lambda: server.get_final_global_mesh(device_mesh=mesh))
        (m_un, v_un, c_un), t_un = _fenced_ms(server.get_final_global_mesh)
        gates = _merge_gates(m_sh, m_un)
        n = int(m_un.num_blocks)
        bc = m_un.block_coords[:n]
        lsb = float(((bc.amax(0) + 1 - bc.amin(0)).float()
                     * ms_spec.block_size).max()) / 65535.0
        matched = _matched_triangles(v_sh, v_un, lsb + 1e-5)
        print(f"[14] phase 12's server, get_final_global_mesh(device_mesh)"
              f" {t_sh:.1f} ms vs unsharded {t_un:.1f} ms: merged layers "
              f"max |Δ| weight {gates[0]:.2e}, sdf {gates[1]:.2e}, colour "
              f"{gates[2]:.2e}; triangles {v_sh.shape[0]} vs "
              f"{v_un.shape[0]}, {matched} matched within one uint16 "
              f"quantum ({lsb:.2e} m) + 1e-5 — {ident}")
        assert v_sh.shape[0] > 1000
        assert abs(v_sh.shape[0] - v_un.shape[0]) <= 1e-3 * v_un.shape[0]
        assert matched >= (1 - 1e-3) * v_un.shape[0], matched
        del m_sh, m_un, v_sh, v_un, fleet_states
        torch.cuda.empty_cache()

        # ---- (5) the dry run: world size 1 here, then two gloo ranks -----
        # with torch's deterministic algorithms on both sides: the card's
        # atomic adds (index_add_) otherwise round H by arrival order, and
        # near the LM's minimum a step then falls either side of its cost
        # rounding (1.7e-4 m apart across runs on an H100)
        n = DRYRUN_ROBOTS
        one, d1_ms = _fenced_ms(lambda: deterministic_dryrun(
            n, device, fl.make_robot_mesh(n, device)))
    t0 = time.perf_counter()
    two = multihost.spawn(deterministic_dryrun, 2, (n, device), device,
                          backend="gloo")
    d2_s = time.perf_counter() - t0
    for rank, res in enumerate(two):
        dp = float(np.abs(res["poses"] - one["poses"]).max())
        assert dp <= 1e-5, (rank, dp)
        assert np.array_equal(res["dist"], one["dist"]), rank
        a = vx.TsdfLayer(**{k: torch.from_numpy(v)
                            for k, v in res["merged"].items()})
        b = vx.TsdfLayer(**{k: torch.from_numpy(v)
                            for k, v in one["merged"].items()})
        _merge_gates(a, b)
    print(f"[14] dryrun_multichip({n}), deterministic algorithms: world "
          f"size 1 {d1_ms:.0f} ms; two gloo ranks on the card ({n // 2} "
          f"robots each, spawned) {d2_s:.1f} s with start-up: poses within "
          f"1e-5, ESDF equal, merge within the gates — {ident}; phase 14 "
          f"took {time.perf_counter() - t_phase:.1f} s")
    del depths, colors
    torch.cuda.empty_cache()
    return fleet_launches, k1_err


def phase_drivers(device, ident):
    """Phase 15: the single-robot demo at its defaults and a 2-lap
    endurance mission (the drivers' gates), K1 ≡ its twin at the mission's
    shapes → (demo's K1 launches, the mission's K1 and K2 launches, K1's
    max |Δ| against its twin)."""
    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.eval import endurance as en

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    since = launches_since()
    demo = demos.single_robot_demo(device)
    demo_k1 = since("k1")
    print(f"[15] single-robot demo: {demo['frames']} frames → "
          f"{demo['submaps']} submaps in {demo['integrate_s']:.2f} s "
          f"({demo['fps']:.2f} frames/s, a fence each render and step); ATE "
          f"raw {demo['ate_raw'] * 100:.2f} cm, after loop + PGO "
          f"{demo['ate_opt'] * 100:.2f} cm; merged {demo['merged_blocks']} "
          f"blocks, {demo['triangles']} triangles, surface p90 "
          f"{demo['surf_p90'] * 100:.2f} cm; K1 launches {demo_k1}; timers "
          f"{json.dumps(demo['timers'])} — {ident}")
    assert demo["ok"], {k: v for k, v in demo.items()
                        if not isinstance(v, np.ndarray)}
    assert demo_k1 == demo["frames"], demo_k1

    mission = en.EnduranceMission(device, laps=2)
    try:
        frames = []
        for f in (0, 1):
            depth, color = mission.frame_at(0, f)
            frames.append((0, depth, color.permute(2, 0, 1).contiguous(),
                           torch.from_numpy(mission.gt[0][f]).to(device)))
        k1_err, _ = k1_against_twin(mission.cfg, device, frames, "15")
        since = launches_since()
        art = mission.run(log=lambda line: print("[15] " + line))
        k1, k2 = since("k1"), since("k2")
    finally:
        mission.close()
    st = art["stage_wall_s"]
    print(f"[15] endurance, {mission.laps} laps burst: {art['frames']} "
          f"frames, pipeline {art['pipeline_fps']} frames/s (wall "
          f"{art['pipeline_wall_s']} s), stream {art['stream_fps']} "
          f"frames/s, real-time factor {art['realtime_factor']}; stage "
          f"walls {json.dumps(st)}; {art['n_solves']} solves "
          f"({art['coalesced_solves']} coalesced, "
          f"{art['async_solve_wall_s']} s); {art['fusions_accepted']} of "
          f"{art['fusion_candidates']} fusions; ATE {art['ate_m']} m; "
          f"final mesh {art['final_mesh_tris']} triangles in "
          f"{art['final_mesh_wall_s']} s, surface p90 "
          f"{art['surface_err_p90_m']} m; K1 launches {k1} for "
          f"{sum(art['integrated_frames'])} integrated frames, K2 launches "
          f"{k2}; gates {art['gates']} — {ident}")
    print("[15] " + json.dumps(art))
    assert art["ok"], art["gates"]
    assert k1 == sum(art["integrated_frames"]) == 2 * mission.n_frames, k1
    assert k2 >= 1, k2
    print(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return demo_k1, k1, k2, k1_err


BENCH_STAGE_KEYS = {
    "union_watermark", "dropped_union_blocks", "esdf_ms", "esdf_blocks",
    "mesh_extract_ms", "mesh_tris", "merge_ms", "serve_while_streaming_fps",
    "serve_live_mesh_tris"}
BENCH_SOLVE_KEYS = {"two_phase_optimize_s", "two_phase_optimize_best_s",
                    "solve_submaps", "solve_pairs"}


def phase_bench(ident, in_script_fps: float, frames: int) -> None:
    """Phase 16: ``python3 bench_torch.py`` in a fresh process from the
    repository root, its JSON line held to bench.py's keys and the bench
    point's gates. A failing run fails the phase."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = subprocess.run(
        [sys.executable, "bench_torch.py"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=900)
    for line in out.stderr.splitlines():
        if line.startswith("# "):
            print("[16] " + line)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise RuntimeError(f"bench_torch.py exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    extra = line["extra_metrics"]
    k1 = [int(m) for m in re.findall(r"K1 launches (\d+)", out.stderr)]
    print(f"[16] bench_torch.py, fresh process: {json.dumps(line)}")
    print(f"[16] tsdf_integration_fps: {line['value']} frames/s in a fresh "
          f"bench_torch.py, {in_script_fps:.2f} in this script (phase 6); "
          f"K1 launches {k1} — {ident}")
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "extra_metrics"}, line
    assert line["metric"] == "tsdf_integration_fps", line
    assert line["unit"] == "frames/s/chip", line
    assert set(extra) == BENCH_STAGE_KEYS | BENCH_SOLVE_KEYS, extra
    assert line["value"] > 0 and line["vs_baseline"] > 0, line
    assert extra["mesh_tris"] > 1000, extra
    assert extra["solve_pairs"] >= 100, extra
    assert extra["dropped_union_blocks"] == 0, extra
    assert k1 == [5 * frames], k1
    print(f"[16] phase 16 took {time.perf_counter() - t_phase:.1f} s")


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures")


def _replay_line(r, syncs, ident) -> str:
    """One drift_correction run's numbers, with ``replay_syncs``'
    counts, as a report line."""
    kf = max(r["keyframes"], 1)
    return (f"{r['point']}: {r['frames']} frames, {r['keyframes']} "
            f"keyframes, {r['closures']} closures, {r['routed']} routed; "
            f"ATE drifted {r['ate_drifted'] * 100:.2f} cm → corrected "
            f"{r['ate_corrected'] * 100:.2f} cm; decode "
            f"{1e3 * r['decode_s'] / r['frames']:.2f} ms/frame, upload "
            f"{1e3 * r['upload_s'] / r['frames']:.3f} ms/frame, step "
            f"{1e3 * r['step_s'] / r['frames']:.2f} ms/frame (fenced); "
            f"detection {r['detect_ms_per_keyframe']:.2f} ms/keyframe "
            f"({syncs['per_keyframe']:.2f} syncs/keyframe, "
            f"{r['k2_launches'] / kf:.2f} K2 launches/keyframe, "
            f"{r['k2_launches']} in all); routing + local PGO "
            f"{r['route_ms_per_routed']:.2f} ms per routed closure over "
            f"{r['routed']} solves ({syncs['per_routed']:.2f} syncs each); "
            f"K1 launches {r['k1_launches']}; mirror |d| {r['mirror_err']}"
            f" — {ident}")


def replay_syncs(point, device, timed):
    """The host syncs of ``drift_correction``'s path at ``point``, counted
    in a second, untimed run under sync-debug ``warn`` (``count_syncs``,
    one call at a time, fences outside): the point's detector alone over
    the clip, then the mapper alone (``map_drifted`` without a detector)
    and the closures routed one ``map_fusion`` at a time through
    ``intra_client_server`` → {per_keyframe, per_routed, same}: ``same``
    says whether this run found ``timed``'s closures and routed flags."""
    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.frontends import loop_detector as ld

    cfg, det_cfg, rp, _, _, drifted = demos.replay_inputs(
        os.path.join(FIXTURES, point), point, device)
    frames = list(rp)
    det = ld.LoopDetector(cfg.intrinsics, det_cfg, device)
    closures, det_syncs = [], 0
    for f in frames:
        out, n = count_syncs(
            lambda f=f: det.add_keyframe(0, f.t, f.color, f.depth))
        closures += out
        det_syncs += n
    mapper = demos.map_drifted(frames, drifted, cfg, None, device)[0]
    _, server = demos.intra_client_server(cfg, mapper, device)
    flags, route_syncs = [], 0
    for mf in closures:
        ok, n = count_syncs(lambda mf=mf: server.map_fusion(mf))
        flags.append(bool(ok))
        route_syncs += n

    def pairs(msgs):
        return [(m.from_time, m.to_time) for m in msgs]

    return {"per_keyframe": det_syncs / max(det.total_keyframes, 1),
            "per_routed": route_syncs / max(sum(flags), 1),
            "same": (pairs(closures) == pairs(timed["closure_msgs"])
                     and flags == timed["routed_flags"])}


def _holey_frames(cfg, device, n: int = 2):
    """The ``n`` tum_real frames with the most depth holes (zeros from the
    fixture's dropout and speckle model), as ``k1_against_twin``'s inputs
    at their ground-truth poses → (frames, hole shares)."""
    from coxgraph_tpu_torch.frontends import replay

    rp = replay.TumRgbdReplay(os.path.join(FIXTURES, "tum_real"),
                              intr=cfg.intrinsics, device=device)
    scored = []
    for i, (_, rgb, dep, T) in enumerate(rp.associations()):
        if i % 12:
            continue
        depth = replay.read_png(dep).astype(np.float32) / rp.depth_factor
        scored.append((float((depth == 0).mean()), rgb, depth, T))
    scored.sort(key=lambda x: -x[0])
    frames = []
    for _, rgb, depth, T in scored[:n]:
        color = replay.read_png(rgb)[..., :3].astype(np.float32) / 255.0
        frames.append((0, torch.from_numpy(depth).to(device),
                       torch.from_numpy(color).to(device).permute(
                           2, 0, 1).contiguous(),
                       torch.from_numpy(T).to(device)))
    return frames, [x[0] for x in scored[:n]]


def replay_k2(det, device, ident):
    """K2 ≡ its plain version on the real-texture descriptors of the
    replay detector's pool: its scoring launch (one keyframe against the
    detector's ``match_chunk`` slots) and its verify launch's form (3
    keyframes, each against another's slot, b per query); then its times
    at the scoring launch → record (ms, device_ms, plain_ms, bound_ms,
    bound_by). The bound counts the distances this launch's data needs:
    the kernel gives invalid rows and columns closed-form outputs, so
    only valid query rows × valid pool rows need one."""
    from coxgraph_tpu_torch.ops import cuda_hamming as ch

    n_live, slots = det.n_keyframes, det.cfg.match_chunk
    assert n_live >= slots // 2, (n_live, slots)
    desc, valid = det._db_desc, det._db_valid
    q = n_live - 1                               # the last keyframe
    a, av = desc[q:q + 1].contiguous(), valid[q:q + 1].contiguous()
    b = desc[None, :slots].contiguous()
    bv = valid[None, :slots].contiguous()
    got = ch.match_topk(a, av, b, bv, BIG, BIG)
    want = ch.match_topk_reference(a, av, b, bv, BIG, BIG)
    for x, y, name in zip(got, want, ("d1", "i1", "d2", "best_a")):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y), name
    rows = torch.tensor([0, n_live // 2, q], device=device)
    va, vb = desc[rows].contiguous(), desc[rows.flip(0)][:, None]
    vav, vbv = valid[rows].contiguous(), valid[rows.flip(0)][:, None]
    got_v = ch.match_topk(va, vav, vb.contiguous(), vbv.contiguous(), BIG,
                          BIG)
    want_v = ch.match_topk_reference(va, vav, vb, vbv, BIG, BIG)
    for x, y, name in zip(got_v, want_v, ("d1", "i1", "d2", "best_a")):
        assert torch.equal(x, y), ("verify", name)
    n_match = int((got[0] <= 64).sum())
    times = {}
    fns = {"kernel": lambda: ch.match_topk(a, av, b, bv, BIG, BIG),
           "plain": lambda: ch.match_topk_reference(a, av, b, bv, BIG, BIG)}
    for tag in ("plain", "kernel", "graph", "kernel", "graph", "plain"):
        times.setdefault(tag, []).append(
            _graph_ms(fns["kernel"]) if tag == "graph"
            else _time_ms(fns[tag], 20 if tag == "kernel" else 5))
    clock, n_sms = _sm_clock_hz(), torch.cuda.get_device_properties(
        0).multi_processor_count
    K = a.shape[1]
    n_a, n_b = int(av.sum()), int(bv.sum())
    live_slots = int(bv[0].any(-1).sum())
    bound, by, route, floors = _k2_bound(1, slots, K, K, clock, n_sms,
                                         pairs=n_a * n_b)
    dense, dense_by, _, _ = _k2_bound(1, slots, K, K, clock, n_sms)
    rec = dict(ms=min(times["kernel"]), device_ms=min(times["graph"]),
               plain_ms=min(times["plain"]), bound_ms=bound, bound_by=by)
    print(f"[17] K2 ≡ plain on tum_real descriptors: the scoring launch "
          f"(1 x {slots} slots x {K}^2, {n_a} valid query keypoints, "
          f"{n_b} valid pool keypoints in {live_slots} live slots, "
          f"{n_match} rows with d1 <= 64) and the verify launch (3 x 1 x "
          f"{K}^2), every output; scoring launch kernel "
          f"{rec['ms'] * 1e3:.1f} us {times['kernel']} back to back, "
          f"device {rec['device_ms'] * 1e3:.1f} us {times['graph']}, plain "
          f"{rec['plain_ms'] * 1e3:.1f} us {times['plain']}; bound "
          f"{bound * 1e3:.2f} us ({by}) over the {n_a} x {n_b} valid "
          f"pairs (operation floors "
          f"{ {k: round(v * 1e3, 3) for k, v in floors.items()} } us); "
          f"over every {1 * slots * K * K} pairs it would be "
          f"{dense * 1e3:.2f} us ({dense_by}) — {ident}")
    return rec


def phase_replay(device, ident):
    """Phase 17: the real-sequence path (eval.demos.tum_pipeline on
    tum_tiny, drift_correction on tum_loop and tum_real) with the JAX
    tests' gates, K1 ≡ its twin on tum_real frames with depth holes and
    K2 ≡ its plain version on the detector's real-texture descriptors →
    (K1 launches, K2 launches, K1's max |Δ|, K2's record at the scoring
    launch)."""
    from coxgraph_tpu_torch.eval import demos

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    since = launches_since()
    t0 = time.perf_counter()
    tiny = demos.tum_pipeline(os.path.join(FIXTURES, "tum_tiny"), device)
    tiny_s = time.perf_counter() - t0
    k1, k2 = since("k1"), since("k2")
    print(f"[17] tum_tiny: {tiny['frames']} frames → {tiny['submaps']} "
          f"submaps, ATE {tiny['ate']:.3e} m, {tiny['vertices']} mesh "
          f"vertices, surface q90 {tiny['surf_q90'] * 100:.3f} cm; decode "
          f"{1e3 * tiny['decode_s'] / tiny['frames']:.2f} ms/frame, step "
          f"{1e3 * tiny['step_s'] / tiny['frames']:.2f} ms/frame; K1 "
          f"launches {k1}; {tiny_s:.2f} s — {ident}")
    assert tiny["ok"] and tiny["ate"] < 5e-3 and tiny["submaps"] >= 2
    assert tiny["vertices"] > 300 and tiny["surf_q90"] < 0.3, tiny["surf_q90"]
    assert k1 == tiny["frames"] == 10 and k2 == 0, (k1, k2)
    k1_all, k2_all = k1, 0
    runs = {}
    for point in ("tum_loop", "tum_real"):
        since = launches_since()
        t0 = time.perf_counter()
        r = demos.drift_correction(os.path.join(FIXTURES, point), point,
                                   device)
        wall = time.perf_counter() - t0
        k1, k2 = since("k1"), since("k2")
        t0 = time.perf_counter()
        syncs = replay_syncs(point, device, r)
        print(f"[17] {_replay_line(r, syncs, ident)}; {wall:.2f} s (the "
              f"sync count's untimed run {time.perf_counter() - t0:.2f} s,"
              f" the same closures and routing: {syncs['same']})")
        g = demos.REPLAY_GATES[point]
        assert r["ate_drifted"] > g["min_drifted"], r["ate_drifted"]
        assert r["closures"] >= g["min_closures"], r["closures"]
        assert r["routed"] >= g["min_routed"], r["routed"]
        assert r["ate_corrected"] < g["ratio"] * r["ate_drifted"], (
            r["ate_corrected"], r["ate_drifted"])
        assert r["ate_corrected"] < g["max_corrected"], r["ate_corrected"]
        assert r["ok"] and r["mirror_err"] == 0.0, r["mirror_err"]
        assert k1 == r["k1_launches"] == r["frames"] == 144, k1
        assert k2 == r["k2_launches"] > 0, k2
        k1_all += k1
        k2_all += k2
        runs[point] = r
    real = runs["tum_real"]
    cfg = demos.tum_real_config()[0]
    frames, holes = _holey_frames(cfg, device)
    print(f"[17] K1 ≡ twin on tum_real frames with depth holes (hole "
          f"shares {[round(h, 4) for h in holes]})")
    k1_err, _ = k1_against_twin(cfg, device, frames, "17")
    assert min(holes) > 0.001, holes
    k2_rec = replay_k2(real["detector"], device, ident)
    wall = time.perf_counter() - t_phase
    print(f"[17] replay path: K1 launches {k1_all} (one per frame: 10 + "
          f"144 + 144), K2 launches {k2_all}; phase 17 took {wall:.1f} s "
          f"— {ident}")
    return k1_all, k2_all, k1_err, k2_rec


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
    n_mma = _tensor_core_instructions(_build, "hamming")
    print(f"[2] K2 on the tensor cores: {n_mma} IMMA/IGMMA instructions in "
          f"its SASS (cuobjdump -sass)")
    assert n_mma > 0, "K2 has no tensor-core instruction"

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
    # K1's least time: each live block's 5 pool rows read and written
    # once, the depth and colour images and the lane arrays read once;
    # ~75 f32 operations per voxel of a live block
    v3 = spec.voxels_per_side ** 3
    k1_bytes = (n_live * (2 * 5 * v3 * 4 + 12) + args[1].shape[0] * 5
                + 4 * 4 * intr.height * intr.width + 28)
    k1_bound, k1_by = _bound_ms(k1_bytes, 75 * n_live * v3, F32_FLOPS)
    k1_cold_ms, k1_warm_ms, cycle_mb = k1_device_times(spec, icfg, intr, lk,
                                                       args)
    print(f"[6] block update at the bench point ({args[1].shape[0]} lanes, "
          f"{n_live} live blocks): kernel {kernel_ms * 1e3:.1f} us/call "
          f"{timings['kernel']} back to back, device time cold "
          f"{k1_cold_ms * 1e3:.1f} us ({cycle_mb:.0f} MB of distinct rows "
          f"per graph cycle), warm {k1_warm_ms * 1e3:.1f} us (the same "
          f"rows), bound {k1_bound * 1e3:.1f} us ({k1_by}); torch twin "
          f"{plain_ms * 1e3:.1f} us/call {timings['plain']} ms — {ident}")
    assert cycle_mb >= 100, cycle_mb
    del lk, lt, args
    torch.cuda.empty_cache()

    # ---- 6a. the allocation pass alone at client_vga's shapes -----------
    alloc = alloc_pass_record(device, depths, traj, ident)
    torch.cuda.empty_cache()

    # ---- 4. main path ----------------------------------------------------
    launches, alloc_launches = phase_main_path(cfg, device, depths, colors,
                                               traj)
    torch.cuda.empty_cache()

    # ---- 5. real state size --------------------------------------------
    hm = phase_state_size(device, depths, colors, traj)

    # ---- 11. the solve half (on phase 5's mapper) -------------------------
    phase_solve(device, ident, hm)
    del hm
    torch.cuda.empty_cache()

    # ---- 6b. end-to-end benchmark ---------------------------------------
    fps = bm.tsdf_benchmark(depths, colors, traj)
    print(f"[6] tsdf_integration_fps {fps:.2f} frames/s (4 windows x "
          f"{depths.shape[0]} frames, 640x480, 5 cm) — {ident}")

    n_frames = depths.shape[0]

    # ---- 10. serving path --------------------------------------------------
    serve_launches, esdf = phase_serving(cfg, device, depths, colors, traj,
                                         ident)
    print(f"[10] K1 launches on the serving path: {serve_launches}")
    del depths, colors, traj
    torch.cuda.empty_cache()

    # ---- 7. K2 vs its plain version ---------------------------------------
    k2_err, k2 = phase_hamming(device, ident)

    # ---- 8. loop-detection main path ------------------------------------
    k2_launches = phase_loop_detection(device, ident)
    torch.cuda.empty_cache()

    # ---- 9. stock detector state -------------------------------------------
    phase_detector_state(device, ident)
    torch.cuda.empty_cache()

    # ---- 12. the two-robot server tier ----------------------------------
    server = phase_two_robot(device, ident)

    # ---- 13. the distributed deployment ---------------------------------
    max_err = max(max_err, phase_distributed(device, ident))

    # ---- 14. the parallel tier --------------------------------------------
    fleet_launches, k1_err = phase_parallel(device, ident, server)
    max_err = max(max_err, k1_err)
    del server
    torch.cuda.empty_cache()

    # ---- 15. the drivers ------------------------------------------------
    demo_launches, end_k1, end_k2, k1_err = phase_drivers(device, ident)
    max_err = max(max_err, k1_err)
    torch.cuda.empty_cache()

    # ---- 16. the bench entry in a fresh process ----------------------------
    phase_bench(ident, fps, n_frames)

    # ---- 17. real RGB-D sequences -----------------------------------------
    replay_k1, replay_k2_launches, k1_err, k2_replay = phase_replay(device,
                                                                    ident)
    max_err = max(max_err, k1_err)

    print(json.dumps({"kernels": [{
        "name": "tsdf_update_blocks",
        "route": "cuda",
        "source": "coxgraph_tpu_torch/csrc/tsdf_update.cu",
        "replaces": "coxgraph_tpu/ops/pallas_tsdf.py:214",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "device_ms": k1_cold_ms,
        "warm_device_ms": k1_warm_ms,
        "fleet_launches": fleet_launches,
        "single_robot_launches": demo_launches,
        "endurance_launches": end_k1,
        "replay_launches": replay_k1,
    }, {
        "name": "hamming_topk",
        "route": "cuda",
        "source": "coxgraph_tpu_torch/csrc/hamming_match.cu",
        "replaces": "coxgraph_tpu/ops/pallas_kernels.py:36",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "bound_route": k2["bound_route"],
        "popc_bound_ms": k2["popc_bound_ms"],
        "device_ms": k2["device_ms"],
        "matmul_ms": k2["matmul_ms"],
        "pool_ms": k2["pool_ms"],
        "pool_device_ms": k2["pool_device_ms"],
        "endurance_launches": end_k2,
        "replay_launches": replay_k2_launches,
        "replay_ms": k2_replay["ms"],
        "replay_device_ms": k2_replay["device_ms"],
        "replay_plain_ms": k2_replay["plain_ms"],
        "replay_bound_ms": k2_replay["bound_ms"],
        "replay_bound_by": k2_replay["bound_by"],
    }, {
        "name": "tsdf_alloc",
        "route": "cuda",
        "source": "coxgraph_tpu_torch/csrc/tsdf_alloc.cu",
        "replaces": None,   # no TPU kernel: the JAX package's pass is XLA
        "launches": alloc_launches,
        "max_abs_err": 0,
        "library_ms": None,
        **alloc,
    }, {
        "name": "esdf_sweep",
        "route": "cuda",
        "source": "coxgraph_tpu_torch/csrc/esdf_sweep.cu",
        "replaces": None,   # no TPU kernel: the JAX package's sweeps are XLA
        "max_abs_err": 0,
        "library_ms": None,
        **esdf,
    }]}))
    print(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
