#!/usr/bin/env python3
"""K1 (coxgraph_tpu_torch/csrc/tsdf_update.cu) timed against variants of
its own source, on a CUDA GPU.

    python3 tools/time_k1_variants.py [--variants NAME,...] [--rounds N]

Builds the block-update kernel from the repository's source ("as is") and
from copies of it changed by the edits named in VARIANTS (each edit must
match the source exactly once, so a variant that no longer applies fails
the run), one nvcc per build, all started together, with the port's
flags, into the git-ignored csrc/build/variants/. The committed build is
also run on the live lanes alone. The operating point is chip_smoke.py's:
the bench clip's frame 1 (640x480, 5 cm voxels, 16^3 blocks, 512 lanes)
on pools that hold frame 0. Exact runs are first held to the torch twin
(cuda_tsdf.update_blocks_reference) with torch.equal on every pool there
and at 5^3 blocks (the per-voxel path); the others leave part of the work
out on purpose and are only timed. Then each run's device microseconds
per launch come from CUDA-graph replays (chip_smoke.capture), cold (the
captured launches cycle over chip_smoke.k1_cold_pairs: copies of the
frame's rows in every submap of two collections, at least twice the 50
MB L2, so rows come from HBM) and warm (the same rows every launch), in
rounds that visit the runs in order and then in reverse. Prints the
card's nvidia-smi line, each build's ptxas register line, and one line
per run. Fails without a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

_STREAM = [
    ("*reinterpret_cast<const float2*>(src)",
     "__ldcs(reinterpret_cast<const float2*>(src))"),
    ("x[0] = *src;", "x[0] = __ldcs(src);"),
    ("*reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);",
     "__stcs(reinterpret_cast<float2*>(dst), make_float2(x[0], x[1]));"),
    ("*dst = x[0];", "__stcs(dst, x[0]);")]
_GATHER_D = "d[j] = p.depth[in_img ? lin[j] : 0];"
_GATHER_C = "ci[ch][j] = plane[ch][in_img ? lin[j] : 0];"
# name → (exact, [(text, replacement), ...])
VARIANTS = {
    # one CTA per work item instead of the persistent grid
    "static": (True, [("const int grid = p.n_items < n ? p.n_items : n;",
                       "const int grid = p.n_items;")]),
    # 128 and 256 threads per CTA instead of 512 (work items of 256 and
    # 512 voxels at 2 voxels per thread)
    "threads128": (True, [("constexpr int kThreads = 512;",
                           "constexpr int kThreads = 128;")]),
    "threads256": (True, [("constexpr int kThreads = 512;",
                           "constexpr int kThreads = 256;")]),
    # 1 voxel per thread where the wrapper asks for 2 (work items of 512
    # voxels)
    "vec1": (True, [("launch<2>(p, s)", "launch<1>(p, s)")]),
    # rows loaded and stored evict-first
    "stream_rows": (True, _STREAM),
    # the depth and colour pixels read past L1 (cached in L2 only)
    "gathers_l2": (True, [(_GATHER_D,
                           "d[j] = __ldcg(&p.depth[in_img ? lin[j] : 0]);"),
                          (_GATHER_C,
                           "ci[ch][j] = __ldcg(&plane[ch][in_img ? lin[j] "
                           ": 0]);")]),
    # ablations: the colour rows and pixels left out
    "no_color": (False, [("const bool with_color = p.color != nullptr;",
                          "const bool with_color = false;")]),
    # no depth or colour pixel read (the projection still feeds the update)
    "no_gathers": (False, [(_GATHER_D,
                            "d[j] = 1.0f + 1e-7f * (float)lin[j];"),
                           (_GATHER_C, "ci[ch][j] = 0.5f;")]),
    # the grid alone: each work item reads its lane's mask byte, no more
    "grid_only": (False, [("    if (!p.mask[lane]) continue;\n",
                           "    if (!p.mask[lane] || p.mb >= 0) continue;\n")]),
}


def _edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"edit does not apply once: {old!r}")
        src = src.replace(old, new)
    return src


def build(names):
    """Write and compile every build → {name: (ctypes library, exact)}."""
    from coxgraph_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "tsdf_update.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    builds = {"as is": (True, [])}
    builds.update((n, VARIANTS[n]) for n in names)
    procs = {}
    for name, (exact, edits) in builds.items():
        stem = os.path.join(out, "k1_" + name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(_edited(src, edits))
        cmd = [_build.nvcc_path(), *_build.COMPILE_FLAGS, "-shared", "-o",
               stem + ".so", stem + ".cu"]
        procs[name] = (stem, exact, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (stem, exact, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        regs = sorted({ln.split("Used ")[-1].strip() for ln in
                       log.splitlines() if "registers" in ln})
        print(f"build {name}: ptxas {regs}")
        libs[name] = (ctypes.CDLL(stem + ".so"), exact)
    return libs


def bench_point(device, vps=16):
    """(config, pools holding frame 0, frame 1's update arguments) at the
    bench point, or at ``vps`` voxels per side with 0.8 m blocks."""
    from coxgraph_tpu_torch.core import geometry as geo
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import cuda_alloc, cuda_tsdf

    cfg = bm._mapper_config()
    cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
        cfg.spec, voxels_per_side=vps, voxel_size=0.8 / vps))
    depths, colors, traj = bm.generate_frames(device)   # the bench clip
    planar = colors.permute(0, 3, 1, 2).contiguous()
    layers = sm.create_collection(cfg, device).layers
    k = torch.zeros((), dtype=torch.int32, device=device)
    marks = cuda_alloc.new_marks(cfg.spec, device)
    for f in range(2):
        slots, mask = cuda_alloc.alloc_pass(cfg.spec, cfg.integrator,
                                            cfg.intrinsics, layers, k,
                                            depths[f], traj[f], None, marks)
        args = (k, slots, mask, depths[f], planar[f], geo.inverse(traj[f]))
        if f == 0:
            cuda_tsdf.update_blocks(cfg.spec, cfg.integrator,
                                    cfg.intrinsics, layers, *args)
    return cfg, layers, args


def _clone(layers):
    return type(layers)(**{f.name: getattr(layers, f.name).clone()
                           for f in dataclasses.fields(layers)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names from VARIANTS")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.ops import cuda_tsdf

    device = runtime.require_cuda()
    print(runtime.gpu_identity())
    names = [n for n in args.variants.split(",") if n]
    libs = build(names)

    # runs: name → (library, exact, live lanes only)
    runs = {name: (lib, exact, False) for name, (lib, exact) in libs.items()}

    # exactness first: every exact run ≡ the twin, both paths
    for vps in (16, 5):
        cfg, layers, ops = bench_point(device, vps)
        want = _clone(layers)
        cuda_tsdf.update_blocks_reference(cfg.spec, cfg.integrator,
                                          cfg.intrinsics, want, *ops)
        for name, (lib, exact, _) in runs.items():
            if not exact:
                continue
            got = _clone(layers)
            cuda_tsdf.launch(lib, cfg.spec, cfg.integrator, cfg.intrinsics,
                             got, *ops)
            torch.cuda.synchronize()
            for f in dataclasses.fields(got):
                assert torch.equal(getattr(got, f.name),
                                   getattr(want, f.name)), (name, vps,
                                                            f.name)
        print(f"exact runs ≡ twin at {vps}^3 blocks, "
              f"{int(ops[2].sum())} live lanes of {ops[1].shape[0]}")
        del layers, want, got

    cfg, layers, ops = bench_point(device)
    spec, icfg, intr = cfg.spec, cfg.integrator, cfg.intrinsics
    n_live = int(ops[2].sum())
    if bool(ops[2][:n_live].all()):
        # the live lanes lead: the committed kernel on them alone shows
        # what the masked lanes' work items cost
        runs["as is, live lanes only"] = (libs["as is"][0], True, True)
    pairs, cycle_mb = chip_smoke.k1_cold_pairs(spec, layers, n_live)
    print(f"bench point: {n_live} live lanes of {ops[1].shape[0]}; cold "
          f"cycle of {len(pairs)} launches over {cycle_mb:.0f} MB of "
          f"distinct rows")

    graphs = {}
    for name, (lib, _, live_only) in runs.items():
        lanes = slice(0, n_live if live_only else None)
        run_ops = (ops[1][lanes].contiguous(), ops[2][lanes].contiguous(),
                   *ops[3:])

        def launch(c, kk, lib=lib, run_ops=run_ops):
            cuda_tsdf.launch(lib, spec, icfg, intr, c, kk, *run_ops)

        cold = chip_smoke.round_robin(pairs, launch)
        warm = chip_smoke.round_robin([(layers, ops[0])], launch)
        graphs[name] = {"cold": (chip_smoke.capture(cold, 2 * len(pairs)),
                                 2 * len(pairs)),
                        "warm": (chip_smoke.capture(warm, 20), 20)}
    replays = 10
    times = {name: {"cold": [], "warm": []} for name in runs}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(args.rounds):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for name in order:
            for kind, (g, reps) in graphs[name].items():
                torch.cuda.synchronize()
                start.record()
                for _ in range(replays):
                    g.replay()
                end.record()
                torch.cuda.synchronize()
                times[name][kind].append(
                    start.elapsed_time(end) * 1e3 / (reps * replays))
    for name, t in times.items():
        print(f"{name}: cold min {min(t['cold']):.1f} us per launch, rounds "
              f"{[round(x, 1) for x in t['cold']]}; warm min "
              f"{min(t['warm']):.1f} us, rounds "
              f"{[round(x, 1) for x in t['warm']]}")


if __name__ == "__main__":
    main()
