#!/usr/bin/env python3
"""K2 (coxgraph_tpu_torch/csrc/hamming_match.cu) timed against variants of
its own source, on a CUDA GPU.

    python3 tools/time_k2_variants.py [--variants NAME,...] [--rounds N]

Builds the Hamming kernel from the repository's source ("as is") and from
copies of it changed by the edits named in VARIANTS (each edit must match
the source exactly once, so a variant that no longer applies fails the
run), one nvcc per build, all started together, with the port's flags,
into the git-ignored csrc/build/variants/. Then it times each build's
scoring launch at the endurance point (8 queries x 64 slots x 384^2, b
shared) and the stock point (4 x 128 x 512^2): device microseconds per
launch from CUDA-graph replays of 20 launches, in rounds that visit the
builds in order and then in reverse. Builds marked exact are first held
to the plain version (cuda_hamming.match_topk_reference) at both points
and at 5 queries x 64 slots x 384^2 (an odd query count); the others
leave part of the work out on purpose, give wrong outputs and are only
timed. Prints the card's nvidia-smi line, each build's ptxas register
line, and one line per point with every build's times. Fails without a
CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

BIG = 10_000
# (queries, slots per launch, keypoints) of the two scoring launches
POINTS = {"endurance": (8, 64, 384), "stock": (4, 128, 512)}

_EPI0 = "tile_epilogue<kCols, 0>(acc[0], st, scol, n, t, part);"
_EPI1 = "tile_epilogue<kCols, 1>(acc[1], st, scol, n, t, part);"
_FOLD = ("if (kCols) fold_columns(", "if (false) fold_columns(")
# the products stay live through one word each, or ptxas drops the wgmma
_SINK = [("int part[8];   // column minimum over this thread's four rows",
          "int part[8];\n      int sink = 0;"),
         ("      // the four lanes of a quad hold one row's top-2",
          "      if (sink == 0x7FFFFFFF) p.d1[0] = sink;\n"
          "      // the four lanes of a quad hold one row's top-2")]
_NO_EPILOGUE = [(_EPI0, "sink ^= acc[0][0];"), (_EPI1, "sink ^= acc[1][0];"),
                _FOLD] + _SINK
_NO_UNPACK = [("w[u] = live[u] ? p.b[col * 8 + ((it >> 4) & 7)] : 0u;",
               "w[u] = 0u;")]
# name → (exact, [(text, replacement), ...])
VARIANTS = {
    # one query per CTA at every launch shape
    "group1": (True, [("constexpr int kMaxGroup = 2;",
                       "constexpr int kMaxGroup = 1;")]),
    # two warpgroups per CTA instead of three
    "two_warpgroups": (True, [("constexpr int kWarps = 12;",
                               "constexpr int kWarps = 8;")]),
    # the row top-2 only: no column minimum
    "no_column_min": (False, [("    if (kCols) {\n#pragma unroll\n"
                               "      for (int e = 0;",
                               "    if (false) {\n#pragma unroll\n"
                               "      for (int e = 0;"), _FOLD]),
    # the products only are read: no keys, top-2 or column minimum
    "no_epilogue": (False, _NO_EPILOGUE),
    # B's words not read: shared memory holds a constant
    "no_unpack": (False, _NO_UNPACK),
    # no wgmma: the accumulators take the A fragments instead
    "no_mma": (False, [(
        "wgmma_n32(acc[m], af[m][s], desc + (uint64_t)(s * 256 >> 4), "
        "s > 0);",
        "{ acc[m][2 * s] = (int)(af[m][s][0] ^ (uint32_t)desc); "
        "acc[m][2 * s + 1] = (int)af[m][s][1]; }")]),
    # the products alone
    "mma_only": (False, _NO_EPILOGUE + _NO_UNPACK),
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

    with open(os.path.join(_build.CSRC, "hamming_match.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    builds = {"as is": (True, [])}
    builds.update((n, VARIANTS[n]) for n in names)
    procs = {}
    for name, (exact, edits) in builds.items():
        stem = os.path.join(out, name.replace(" ", "_"))
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
        lib = ctypes.CDLL(stem + ".so")
        lib.cox_hamming_topk.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p])
        lib.cox_hamming_topk.restype = ctypes.c_int
        libs[name] = (lib, exact)
    return libs


def inputs(nq, cap, k, gen):
    """Scoring-launch operands as chip_smoke.py's phase 7 makes them:
    random words, half of each query's descriptors revisited in slot q,
    ~90% valid."""
    dev = gen.device
    a = torch.randint(-2 ** 31, 2 ** 31, (nq, k, 8), dtype=torch.int32,
                      generator=gen, device=dev)
    b = torch.randint(-2 ** 31, 2 ** 31, (1, cap, k, 8), dtype=torch.int32,
                      generator=gen, device=dev)
    b[0, :nq, : k // 2] = a[:, : k // 2]
    av = torch.rand(nq, k, generator=gen, device=dev) < 0.9
    bv = torch.rand(1, cap, k, generator=gen, device=dev) < 0.9
    return a, av, b, bv


def launcher(lib, a, av, b, bv):
    """→ (outputs, a function that launches once on the current stream)."""
    nq, k = a.shape[:2]
    cap, kb = b.shape[1:3]
    outs = [torch.empty((nq, cap, k), dtype=torch.int32, device=a.device)
            for _ in range(3)]
    outs.append(torch.empty((nq, cap, kb), dtype=torch.int32,
                            device=a.device))

    def launch():
        err = lib.cox_hamming_topk(
            a.data_ptr(), av.data_ptr(), b.data_ptr(), bv.data_ptr(),
            *(o.data_ptr() for o in outs), nq, cap, k, kb, 0, BIG, BIG,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return outs, launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names from VARIANTS")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.ops import cuda_hamming as ch

    device = runtime.require_cuda()
    print(runtime.gpu_identity())
    names = [n for n in args.variants.split(",") if n]
    libs = build(names)
    gen = torch.Generator(device=device).manual_seed(0)

    # exactness first: every exact build ≡ the plain version
    for nq, cap, k in list(POINTS.values()) + [(5, 64, 384)]:
        ops = inputs(nq, cap, k, gen)
        want = ch.match_topk_reference(*ops, BIG, BIG)
        for name, (lib, exact) in libs.items():
            if not exact:
                continue
            got, launch = launcher(lib, *ops)
            launch()
            for g, w, what in zip(got, want, ("d1", "i1", "d2", "best_a")):
                assert torch.equal(g, w), (name, nq, cap, k, what)
        del want
        print(f"exact builds ≡ plain at {nq} x {cap} x {k}^2")

    reps, replays = 20, 10
    for point, (nq, cap, k) in POINTS.items():
        ops = inputs(nq, cap, k, gen)
        graphs, keep = {}, []
        for name, (lib, _) in libs.items():
            # the outputs outlive the graph that writes them (entering a
            # capture frees the allocator's unused blocks)
            outs, launch = launcher(lib, *ops)
            keep.append(outs)
            launch()                                    # warm-up
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    launch()
            graph.replay()
            graphs[name] = graph
        times = {name: [] for name in libs}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for r in range(args.rounds):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for name in order:
                torch.cuda.synchronize()
                start.record()
                for _ in range(replays):
                    graphs[name].replay()
                end.record()
                torch.cuda.synchronize()
                times[name].append(
                    start.elapsed_time(end) * 1e3 / (reps * replays))
        for name, ts in times.items():
            print(f"{point} ({nq} x {cap} x {k}^2) {name}: min "
                  f"{min(ts):.1f} us per launch, rounds "
                  f"{[round(t, 1) for t in ts]}")
        del graphs, keep
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
