"""coxgraph_tpu_torch.parallel.multihost and eval.dryrun on the CPU: the
distributed fleet_optimize across two gloo processes that meet over TCP
on localhost (tests/multihost_problem.py's four robots, two a process,
as tests/test_multihost.py runs the JAX package's), its collective byte
count, and the multi-robot dry run over two ranks.

Tolerances: the two processes hold the same poses and match the
single-process solve bit for bit (test_multihost.py allows 1e-6 and
5e-5), and the JAX package's single-process solve within 1e-4; byte
counts exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import multihost_problem as mp
from coxgraph_tpu.parallel import esdf_sharded as jes
from coxgraph_tpu.parallel import fleet as jfl
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.eval import dryrun
from coxgraph_tpu_torch.ops import esdf as esdf_ops
from coxgraph_tpu_torch.parallel import esdf_sharded as es
from coxgraph_tpu_torch.parallel import fleet as fl
from coxgraph_tpu_torch.parallel import multihost
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import interop
from test_torch_mesh import one_thread  # noqa: F401
from torch_parallel_workers import solve

CPU = torch.device("cpu")
CFG = interop.config_from(mp.CFG)
ITERS = 8


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in interop.flatten(tree).items()}


@pytest.fixture(scope="module")
def problem():
    """The shared problem as numpy, JAX's single-process solve, the port's
    in this process and in two spawned processes."""
    torch.set_num_threads(1)
    jfleet, jinter = mp.build_fleet_problem()
    fleet_np, inter_np = _np(jfleet), _np(jinter)
    mesh = jfl.make_robot_mesh(mp.R)
    _, jposes = jfl.fleet_optimize(mp.CFG, mesh, jfl.shard_fleet(jfleet, mesh),
                                   jinter, jpg.SolverConfig(iterations=ITERS))
    with multihost.single_process(CPU):
        one = solve(fleet_np, inter_np, CFG, ITERS)
    two = multihost.spawn(solve, 2, (fleet_np, inter_np, CFG, ITERS),
                          device=CPU)
    return fleet_np, inter_np, np.asarray(jposes), one, two


def _total_cost(fleet_np, inter_np, poses) -> float:
    S = mp.S
    parts = [fl.globalize_constraints(interop.constraints_from_numpy(
        {k.split(".", 1)[1]: v[r] for k, v in fleet_np.items()
         if k.startswith("constraints.")}, CPU), r, S) for r in range(mp.R)]
    scfg = pg.SolverConfig()
    P = torch.from_numpy(poses)
    inter = interop.constraints_from_numpy(inter_np, CPU)
    return float(sum(pg._total_cost(P, c, scfg) for c in parts)
                 + pg._total_cost(P, inter, scfg))


def test_two_process_fleet_optimize(problem):
    fleet_np, inter_np, jposes, one, two = problem
    p0, p1 = two[0]["poses"], two[1]["poses"]
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(p0, one["poses"])
    np.testing.assert_allclose(one["poses"], jposes, atol=1e-4, rtol=0)
    init = fleet_np["collection.T_odom_submap"].reshape(-1, 7)
    assert _total_cost(fleet_np, inter_np, p0) <= \
        _total_cost(fleet_np, inter_np, init) + 1e-6


def test_fleet_optimize_comm_bytes(problem):
    """The collectives' own count of one solve, against the formula: per
    LM iteration one all_reduce of [H | b] (6N·6N + 6N f32, the H and b of
    fleet.ici_bytes_per_optimize's per_iteration_bytes) and one gather of
    the new cost (one f32 a robot, where the JAX package reduces one
    scalar); once per solve the pose vector's gather (N·7 f32, its
    all_gather_bytes), the start cost's and the touched-pose mask (N
    int32). The same on every rank and at any world size (the gather
    buffers are whole)."""
    R, N = mp.R, mp.R * mp.S
    d = 6 * N
    ici = fl.ici_bytes_per_optimize(CFG, R,
                                    pg.SolverConfig(iterations=ITERS))
    want_iter = {"all_reduce": (d * d + d) * 4, "all_gather": R * 4}
    want_setup = {"all_gather": N * 7 * 4 + R * 4, "all_reduce": N * 4}
    comm = problem[3]["comm"]
    assert comm["per_iteration"] == want_iter
    assert comm["setup"] == want_setup
    assert comm["per_optimize"] == (sum(want_setup.values())
                                    + ITERS * sum(want_iter.values()))
    assert want_iter["all_reduce"] == ici["per_iteration_bytes"] - 4
    assert want_setup["all_gather"] == ici["all_gather_bytes"] + R * 4
    assert comm["per_optimize"] == (ici["per_device_bytes"] + N * 4
                                    + (ITERS + 1) * R * 4 - ITERS * 4)
    assert [r["comm"] for r in problem[4]] == [comm, comm]


def test_dryrun_over_two_ranks():
    """dryrun_multichip(8) with four robots a rank: its own gates hold on
    each rank, and both ranks hold the same poses, ESDF and fused layer."""
    a, b = dryrun.spawn_dryrun(8, 2, CPU)
    assert a["nblocks"] == b["nblocks"] >= 512
    assert a["poses"].shape == (8 * dryrun.S, 7)
    assert np.isfinite(a["poses"]).all()
    assert int(a["merged"]["num_blocks"]) >= 512
    np.testing.assert_array_equal(a["poses"], b["poses"])
    np.testing.assert_array_equal(a["dist"], b["dist"])
    for k, v in a["merged"].items():
        np.testing.assert_array_equal(v, b["merged"][k], err_msg=k)


def test_jax_dryrun_slabs_overflow_below_eight_devices():
    """Reference fault (ROADMAP queue 3): __graft_entry__.dryrun_multichip
    partitions its 512-block sphere into n slabs of a fixed 160 blocks, so
    at n < 8 a slab overflows (2 slabs: 256 blocks each) and the dry run
    cannot run; its ≥ 512-block fleet gate needs ≥ 5 robots besides. The
    port fits the capacities to the partition (esdf_sharded.fitted_config)
    and its dry run's ESDF matches the single-device ESDF at 2 slabs."""
    spec = dataclasses.replace(dryrun.dryrun_config().spec, max_blocks=640)
    layer = dryrun.sphere_layer(spec, CPU)
    jlayer = jes.vx.TsdfLayer(**{k: jax.numpy.asarray(v) for k, v in
                                 interop.layer_to_numpy(layer).items()})
    jcfg = jes.ShardedEsdfConfig(
        per_device_blocks=160, halo_blocks=64,
        esdf=jes.esdf_ops.EsdfConfig(max_distance=1.5))
    with pytest.raises(AssertionError, match="capacity 160"):
        jes.partition_blocks(jes.vx.VoxelGridSpec(**dataclasses.asdict(spec)),
                             jlayer, 2, jcfg)
    ecfg = es.fitted_config(spec, layer, 2,
                            esdf_ops.EsdfConfig(max_distance=1.5))
    assert ecfg.per_device_blocks == 256
    parts = es.partition_blocks(spec, layer, 2, ecfg)
    with multihost.single_process(CPU):
        mesh = fl.make_robot_mesh(device=CPU)
        got = es.gather_to_layer(spec, layer, parts,
                                 es.esdf_sharded(spec, mesh, parts, ecfg),
                                 mesh)
    want = esdf_ops.esdf_from_tsdf(spec, layer, ecfg.esdf)
    assert torch.equal(got.dist[:512], want.dist[:512])


def test_entry_points_need_a_group_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="process group"):
        fl.make_robot_mesh(2, CPU)


def test_entry_integrates_a_frame():
    """entry()'s function: one frame into an empty 2,048-block layer."""
    fn, args = dryrun.entry(CPU)
    layer = fn(*args)
    assert int(layer.num_blocks) > 0 and float(layer.weight.max()) > 0
