"""coxgraph_tpu_torch.server (fusion server + client interface) vs
coxgraph_tpu.server on tests/test_server.py's two-client world.

The world is built once per module by the JAX package (mapper_step over
8 frames a robot) and carried into the port with utils.interop, so both
servers start from the same arrays. The same MapFusionMsg sequence
(test_server's true fusions at frames (3, 3) and (6, 5)) then runs
through both, async_pgo off.

Tolerances: constraint pools' i / j / valid / count, constraint_kinds,
cli_ser, fused and the send-once byte counts exact; T_meas within 1e-5
(observed: equal); T_G_cli and the submap poses within 1e-3 m and 1e-3
rad (observed at most 6.5e-5 m and 1.8e-5 rad on the submaps, 3.4e-5 m
on T_G_cli, after the second fusion's solve). The final mesh at given
poses (fed to both, control off so no solve runs): the merged layer's
block_index, block_coords and num_blocks and the triangles' count and
order exact, sdf / weight / colour within 1e-4 (observed 7.2e-6),
vertices within one quantum of the mesh's uint16 grid plus one f32
rounding (observed: one quantum, 2.2e-4 m) and colours within one uint8
step. Client-pushed meshes after the sequence (one JAX message, seeded
ones, one for a submap neither server holds): published bytes
identical, the combination's faces and colours exact in both colour
modes, each vertex within the pose tolerance.

The other tests hold the port alone to the behaviour test_server.py
checks in the JAX package (future queue, refuse intervals, same-client
fusion, saturation warnings and counters, isolation, ...), on fresh port
copies of the same world; test_torch_async_pgo.py takes
test_async_pgo.py's."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import test_server as ts
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.eval.export import read_ply_counts, \
    read_tum_trajectory
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import mesh as mesh_ops
from coxgraph_tpu_torch.server import fusion_server as fs
from coxgraph_tpu_torch.server.client_interface import InProcessClient
from coxgraph_tpu_torch.utils import interop
from coxgraph_tpu_torch.parallel import multihost
from test_torch_mesh import one_thread  # noqa: F401
from test_torch_solver import pose_errors
from torch_parallel_workers import server_final_mesh

CPU = torch.device("cpu")
CFG = interop.config_from(ts.CFG)
SPEC = CFG.spec
DT = ts.DT
STEPS = [(3, 3), (6, 5)]


def _msg(jmf) -> fs.MapFusionMsg:
    return fs.MapFusionMsg(jmf.from_client, float(jmf.from_time),
                           jmf.to_client, float(jmf.to_time),
                           np.asarray(jmf.T_from_to))


def _record(server, clients):
    """What the parity tests compare after one fusion."""
    pool = interop.pool_to_numpy(server.constraints)
    return {"pool": pool, "kinds": list(server.constraint_kinds),
            "cli_ser": dict(server.cli_ser), "fused": dict(server.fused),
            "bytes": [c.bytes_sent for c in clients],
            "T_G_cli": {c: np.array(T) for c, T in server.T_G_cli.items()},
            "poses": np.stack([np.asarray(s.T_G_submap)
                               for s in server.submaps]),
            "pairs": server.fusion_log[-1]["n_registration_pairs"],
            "candidate_ok": server.candidate_log[-1]["ok"]}


@pytest.fixture(scope="module")
def world():
    """(scene, trajs, X, the clients' states as numpy, the JAX clients) —
    the world of test_server.build_two_clients, built once. The JAX
    package replaces a client's state rather than changing it, so the
    numpy states stay those of the world as built."""
    scene, trajs, X, jclients = ts.build_two_clients()
    states = [{k: np.asarray(v) for k, v in
               interop.flatten(c.state).items()} for c in jclients]
    return scene, trajs, X, states, jclients


def port_clients(world, n=2):
    """Fresh port clients holding the world's states."""
    states = world[3]
    return [InProcessClient(cid, CFG, interop.mapper_state_from_numpy(
        states[cid], CPU)) for cid in range(n)]


def port_server(clients, **kw):
    """The port's twin of test_server.make_server."""
    cfg = fs.ServerConfig(
        spec=SPEC, max_submaps=kw.pop("max_submaps", 32),
        refuse_interval=kw.pop("refuse_interval", 0.0),
        registration=fs.reg.RegistrationConfig(max_points=512, iterations=8),
        **kw)
    return fs.CoxgraphServer(cfg, clients, CPU)


def true_msg(world, ta, tb):
    return _msg(ts.true_fusion_msg(world[1], ta, tb))


@pytest.fixture(scope="module")
def sequence(world):
    """The fusion sequence through both servers → (JAX records, port
    records, JAX server, port server)."""
    torch.set_num_threads(1)
    jclients = world[4]
    pclients = [interop.client_from(c, CPU) for c in jclients]
    jserver = ts.make_server(list(jclients))
    pserver = fs.CoxgraphServer(interop.config_from(jserver.cfg), pclients,
                                CPU)
    jrec, prec = [], []
    for ta, tb in STEPS:
        jmf = ts.true_fusion_msg(world[1], ta, tb)
        assert jserver.map_fusion(jmf)
        assert pserver.map_fusion(_msg(jmf))
        jrec.append(_record(jserver, jclients))
        prec.append(_record(pserver, pclients))
    return jrec, prec, jserver, pserver


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_fusion_sequence_bookkeeping_exact(sequence, step):
    jrec, prec, _, _ = sequence
    j, p = jrec[step], prec[step]
    for name in ("i", "j", "valid", "count"):
        np.testing.assert_array_equal(p["pool"][name],
                                      np.asarray(j["pool"][name]), name)
    np.testing.assert_allclose(p["pool"]["T_meas"], j["pool"]["T_meas"],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(p["pool"]["sqrt_info"],
                                  j["pool"]["sqrt_info"])
    for key in ("kinds", "cli_ser", "fused", "bytes", "pairs",
                "candidate_ok"):
        assert p[key] == j[key], key
    assert p["kinds"].count("fusion") == step + 1


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_fusion_sequence_poses_match_jax(sequence, step):
    jrec, prec, _, _ = sequence
    j, p = jrec[step], prec[step]
    dt, dr = pose_errors(p["poses"], j["poses"])
    assert dt <= 1e-3 and dr <= 1e-3, (dt, dr)
    for c in (0, 1):
        dt, dr = pose_errors(p["T_G_cli"][c][None], j["T_G_cli"][c][None])
        assert dt <= 1e-3 and dr <= 1e-3, (c, dt, dr)
    # client 1's frame alignment recovers X[1], as test_server asks
    err = geo.se3_log(geo.relative(torch.from_numpy(p["T_G_cli"][1]),
                                   torch.from_numpy(_X1()))).norm()
    assert float(err) < (0.12 if step == 0 else 0.1)


def _X1():
    """Client 1's odom frame in the world (build_two_clients' default)."""
    return geo.from_xyzyaw(torch.tensor([1.0, -0.5, 0.0, 0.6])).numpy()


def test_final_mesh_at_given_poses_matches_jax(sequence):
    """Collect every submap, feed the same poses to both servers and mesh
    with control off (no solve): the merge and the extraction at given
    poses. The given poses are JAX's solved ones moved by one generic
    change of the global frame: as solved, every camera is level at the
    room centre's height, so one voxel axis of each submap lands on the
    global lattice, where the trilinear base voxel follows rounding noise
    (tests/test_torch_merge.py's identity case;
    test_merge_at_the_solved_level_poses_follows_rounding below)."""
    _, _, jserver, pserver = sequence
    for s in (jserver, pserver):
        s.control_trigger(False)
        s.collect_all_submaps()
    assert pserver.cli_ser == jserver.cli_ser
    frame = np.concatenate([
        geo.so3_exp(torch.tensor([0.031, -0.017, 0.113])).numpy(),
        [0.0123, -0.0371, 0.0217]]).astype(np.float32)
    for sj, sp in zip(jserver.submaps, pserver.submaps):
        sj.T_G_submap = geo.compose_np(frame, np.asarray(sj.T_G_submap)
                                       ).astype(np.float32)
        sp.T_G_submap = sj.T_G_submap.copy()
    jm, jv, jc = jserver.get_final_global_mesh()
    pm, pv, pc = pserver.get_final_global_mesh()
    got = interop.layer_to_numpy(pm)
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jm, name)), name)
    for name in ("sdf", "weight", "color"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jm, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    # the same triangles in the same order, within one quantum of the
    # uint16 vertex grid over the live blocks (ops/mesh.extract_mesh) plus
    # the f32 rounding of a dequantized coordinate below 8 m (ulp 9.5e-7)
    n = int(jm.num_blocks)
    bc = np.asarray(jm.block_coords)[:n]
    lsb = float(((bc.max(0) + 1 - bc.min(0)) * SPEC.block_size).max()
                ) / 65535.0
    assert pv.shape == jv.shape and pv.shape[0] > 500
    assert np.abs(pv - jv).max() <= lsb + 1e-6
    assert np.abs(pc - jc).max() <= 1.0 / 255 + 1e-6


def match_triangles(a: np.ndarray, b: np.ndarray, atol: float):
    """The order of ``b`` that puts each triangle of ``a`` (T,3,3) beside
    its own triangle of ``b``, every coordinate within ``atol``; None when
    the soups are not the same triangles."""
    from scipy.spatial import cKDTree

    if a.shape != b.shape:
        return None
    d, idx = cKDTree(b.reshape(len(b), -1)).query(a.reshape(len(a), -1),
                                                   p=np.inf)
    if (d > atol).any() or len(np.unique(idx)) != len(a):
        return None
    return idx


@pytest.fixture(scope="module")
def sharded_final_meshes(world):
    """get_final_global_mesh with and without ``device_mesh``, on a server
    over fresh port clients of the world with control off and every
    submap moved by one generic change of the global frame (off the voxel
    lattice, as test_final_mesh_at_given_poses_matches_jax): at world size
    1 in this process and at world size 2 in two spawned gloo ranks."""
    frame = np.concatenate([
        geo.so3_exp(torch.tensor([0.031, -0.017, 0.113])).numpy(),
        [0.0123, -0.0371, 0.0217]]).astype(np.float32)
    scfg = fs.ServerConfig(
        spec=SPEC, max_submaps=32, refuse_interval=0.0,
        registration=fs.reg.RegistrationConfig(max_points=512, iterations=8))
    args = (CFG, scfg, list(world[3]), frame)
    with multihost.single_process(CPU):
        one = server_final_mesh(*args)
    return [one] + multihost.spawn(server_final_mesh, 2, args, device=CPU)


@pytest.mark.parametrize("rank", [None, 0, 1])
def test_sharded_final_mesh_matches_unsharded(sharded_final_meshes, rank):
    """The sharded final mesh (rank None: world size 1) holds the
    unsharded one's triangles: vertices within one quantum of the
    unsharded mesh's uint16 grid plus 1e-5 m (the unsharded path returns
    extract_mesh's quantized vertices, the sharded one f32 values; and the
    sharded merge fuses Σw·sdf / Σw where the sequential merge keeps
    running means, which differ in the last bits), colours within one
    uint8 step plus 1e-5."""
    res = sharded_final_meshes[0 if rank is None else rank + 1]
    (v, c), (vs, cs) = res["sharded"], res["unsharded"]
    assert v.shape[0] > 500
    order = match_triangles(v, vs, res["lsb"] + 1e-5)
    assert order is not None
    assert np.abs(c - cs[order]).max() <= 1.0 / 255 + 1e-5


def test_merge_at_the_solved_level_poses_follows_rounding(sequence):
    """The reference property the test above steps around (ROADMAP queue
    3): at the poses as solved, every camera is level, so the merge
    samples each submap on its half-voxel lattice and the trilinear cell
    follows rounding — jitted JAX and the port then differ on more than
    1e-3 of the merged voxels (observed 0.56%), though the allocation is
    the same."""
    from coxgraph_tpu.core import voxel as jvx
    from coxgraph_tpu.ops import merge as jmerge
    from coxgraph_tpu_torch.ops import merge as pmerge

    jrec, _, jserver, _ = sequence
    poses = jrec[-1]["poses"]
    jm = jvx.create_tsdf_layer(ts.SPEC)
    pm = vx.create_tsdf_layer(SPEC, CPU)
    for k, s in enumerate(jserver.submaps[:len(poses)]):
        jm = jmerge.merge_layer_into_sized(ts.SPEC, jm, s.layer,
                                           jax.numpy.asarray(poses[k]))
        pmerge.merge_layer_into_sized(
            SPEC, pm, interop.layer_from_numpy(
                {f.name: np.array(getattr(s.layer, f.name))
                 for f in dataclasses.fields(s.layer)}, CPU),
            torch.from_numpy(np.array(poses[k])))
    got = interop.layer_to_numpy(pm)
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jm, name)))
    live = (np.asarray(jm.weight) > 0) | (got["weight"] > 0)
    flips = np.abs(got["sdf"] - np.asarray(jm.sdf)) > 1e-4
    share = flips[live].mean()
    assert share > 1e-3, share


# ---------------------------------------------------------------------------
# The behaviour of tests/test_server.py, on the port
# ---------------------------------------------------------------------------


def test_map_fusion_aligns_and_meshes_the_union(world, tmp_path):
    scene = syn.default_scene(CPU)
    server = port_server(port_clients(world))
    assert server.map_fusion(true_msg(world, 3, 3))
    merged, verts, cols = server.get_final_global_mesh(
        str(tmp_path / "global.ply"))
    assert verts.shape[0] > 500
    sdf = syn.scene_sdf(scene, torch.from_numpy(verts.reshape(-1, 3)))
    assert np.quantile(np.abs(sdf.numpy()), 0.9) < 3.0 * SPEC.voxel_size
    spread = verts.reshape(-1, 3)[:, :2]
    assert spread[:, 0].max() - spread[:, 0].min() > 4.0
    assert read_ply_counts(str(tmp_path / "global.ply"))[1] == \
        verts.shape[0]
    stamps1, poses1 = server.pose_history(1)
    order = np.argsort(stamps1)
    gt = np.asarray(world[1][1])[(stamps1[order] / DT).round().astype(int)]
    err = np.linalg.norm(poses1[order][:, 4:7] - gt[:, 4:7], axis=-1)
    assert np.median(err) < 0.12


def test_height_priors_wired_into_fusion_solve(world):
    server = port_server(port_clients(world), height_prior_stddev=0.1)
    assert server.map_fusion(true_msg(world, 3, 3))
    n = len(server.submaps)
    assert int(server.heights.count) == n
    hv = server.heights.valid.numpy()
    assert hv[:n].all() and not hv[n:].any()
    server.collect_all_submaps()
    assert int(server.heights.count) == len(server.submaps)
    server.optimize()
    assert torch.isfinite(server._poses()).all()


def _online(server):
    return ([np.array(s.T_G_submap) for s in server.submaps],
            [np.array(s.T_cli_submap) for s in server.submaps],
            interop.pool_to_numpy(server.constraints),
            list(server.constraint_kinds),
            {c: np.array(T) for c, T in server.T_G_cli.items()})


def _assert_online_equal(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)
    assert len(a[0]) == len(b[0])
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k])
    assert a[3] == b[3]
    for c in a[4]:
        np.testing.assert_array_equal(a[4][c], b[4][c])


def test_final_mesh_isolation(world):
    """get_final_global_mesh(isolate=True) leaves the online graph
    bit-identical; isolate=False keeps the collection."""
    server = port_server(port_clients(world))
    server.map_fusion(true_msg(world, 3, 3))
    before = _online(server)
    _, verts, _ = server.get_final_global_mesh()
    assert verts.shape[0] > 0
    _assert_online_equal(before, _online(server))
    server.get_final_global_mesh(isolate=False)
    assert len(server.submaps) > len(before[0])


def test_snapshot_survives_a_fusion_landing(world):
    """The graph snapshot (final mesh) and a solve's inputs (nonblocking
    PGO) are copies: a fusion landing after them changes neither."""
    server = port_server(port_clients(world))
    assert server.map_fusion(true_msg(world, 3, 3))
    snap = server._snapshot_graph()
    want = {k: v.copy() for k, v in snap["constraints"].fields.items()}
    kinds = list(snap["constraint_kinds"])
    solve_inputs = server.constraints
    inputs_before = interop.pool_to_numpy(solve_inputs)
    assert server.map_fusion(true_msg(world, 6, 5))
    assert server.constraint_kinds.count("fusion") == 2
    for k, v in want.items():
        np.testing.assert_array_equal(snap["constraints"].fields[k], v)
    assert snap["constraint_kinds"] == kinds
    for k, v in interop.pool_to_numpy(solve_inputs).items():
        np.testing.assert_array_equal(v, inputs_before[k])


def test_merge_to_client_map(world):
    scene = syn.default_scene(CPU)
    server = port_server(port_clients(world))
    server.map_fusion(true_msg(world, 3, 3))
    cli_map = server.merge_to_client_map(1)
    verts, _ = mesh_ops.extract_mesh(SPEC, cli_map, min_weight=0.1)
    pts = verts.reshape(-1, 3)
    assert pts.shape[0] > 100
    pts_g = geo.transform_points_np(server.T_G_cli[1], pts)
    sdf = syn.scene_sdf(scene, torch.from_numpy(pts_g.astype(np.float32)))
    assert np.quantile(np.abs(sdf.numpy()), 0.9) < 3.0 * SPEC.voxel_size
    v0, _ = mesh_ops.extract_mesh(SPEC, server.merge_to_client_map(0),
                                  min_weight=0.1)
    c0 = geo.transform_points_np(server.T_G_cli[0],
                                 v0.reshape(-1, 3)).mean(axis=0)
    assert np.linalg.norm(c0[:2] - pts_g.mean(axis=0)[:2]) > 0.3


def test_global_mesh_postprocessed(world, tmp_path):
    scene = syn.default_scene(CPU)
    server = port_server(port_clients(world))
    server.map_fusion(true_msg(world, 3, 3))
    p = str(tmp_path / "clean.ply")
    clean = server.get_final_global_mesh_postprocessed(
        p, taubin_iterations=20)
    _, raw_verts, _ = server.get_final_global_mesh()
    assert 0 < clean.n_vertices < raw_verts.reshape(-1, 3).shape[0]
    assert clean.n_faces > 0
    sdf = syn.scene_sdf(scene, torch.from_numpy(clean.vertices))
    assert np.quantile(np.abs(sdf.numpy()), 0.9) < 3.0 * SPEC.voxel_size
    assert read_ply_counts(p) == (clean.n_vertices, clean.n_faces)


def test_same_client_fusion_becomes_loop_closure(world):
    clients = port_clients(world)
    server = port_server(clients)
    n0 = int(clients[0].state.constraints.count)
    trajs = world[1]
    T = np.asarray(ts.geo.relative(trajs[0][1], trajs[0][7]))
    assert server.map_fusion(fs.MapFusionMsg(0, 1 * DT, 0, 7 * DT, T))
    assert int(clients[0].state.constraints.count) == n0 + 1
    assert server.last_fusion_time[(0, 0)] == 7 * DT


def test_future_fusion_queued_and_retried(world):
    clients = port_clients(world)
    server = port_server(clients)
    mf = fs.MapFusionMsg(0, 3 * DT, 1, 5.0, geo.identity_np())
    assert not server.map_fusion(mf)
    assert len(server.future_queue) == 1
    server.time_line_update()          # still future
    assert len(server.future_queue) == 1
    # advance client 1's timeline by integrating a frame at t = 5.0
    scene = syn.default_scene(CPU)
    T_w = torch.from_numpy(np.array(world[1][1][-1]))
    d, c = syn.render_depth(scene, CFG.intrinsics, T_w)
    X1 = torch.from_numpy(_X1())
    c1 = clients[1]
    with c1.lock:
        _, started = sm.mapper_step(CFG, c1.state, d, c,
                                    geo.compose(geo.inverse(X1), T_w), 5.0)
    assert started
    server.time_line_update()
    assert len(server.future_queue) == 0
    assert len(server.submaps) >= 2


def test_future_retries_are_bounded(world):
    server = port_server(port_clients(world))
    assert not server.map_fusion(fs.MapFusionMsg(0, 3 * DT, 1, 99.0,
                                                 geo.identity_np()))
    for _ in range(server.cfg.max_future_retries + 2):
        server.time_line_update()
    assert server.future_queue == []


def test_refuse_interval_gates_fusions(world):
    server = port_server(port_clients(world), refuse_interval=100.0)
    assert server.map_fusion(true_msg(world, 3, 3))
    assert not server.map_fusion(true_msg(world, 6, 5))
    assert server.need_to_fuse(0, 1, 3 * DT + 200.0)


def test_intra_refuse_interval_gates_same_client_closures(world):
    clients = port_clients(world)
    server = port_server(clients, intra_refuse_interval=10.0)
    T = geo.identity_np()
    assert server.map_fusion(fs.MapFusionMsg(0, 1 * DT, 0, 7 * DT, T))
    n = int(clients[0].state.constraints.count)
    assert not server.map_fusion(fs.MapFusionMsg(0, 2 * DT, 0, 7 * DT, T))
    assert int(clients[0].state.constraints.count) == n


def test_distribution_controller(world):
    server = port_server(port_clients(world))
    server.control_trigger(False)
    server.map_fusion(true_msg(world, 3, 3))   # ingests, no solve
    assert server.state_query()["n_submaps"] >= 2
    assert server.fusion_log == []
    assert server.global_frames() == {}
    server.control_trigger(True)
    server.optimize()
    assert len(server.fusion_log) == 1
    fr = server.global_frames()
    assert set(fr) == {("mission_g", "client0_odom"),
                       ("mission_g", "client1_odom")}


def test_loop_candidate_check_accepts_true_rejects_false(world):
    trajs = world[1]
    bad_T = geo.compose_np(
        np.asarray(ts.geo.relative(trajs[0][6], trajs[1][5])),
        np.array([1.0, 0, 0, 0, 1.5, 0, 0], np.float32))
    bad = fs.MapFusionMsg(0, 6 * DT, 1, 5 * DT, bad_T)
    server = port_server(port_clients(world))
    assert server.map_fusion(true_msg(world, 3, 3))
    assert server.candidate_log[-1]["ok"], server.candidate_log[-1]
    n_fus = server.constraint_kinds.count("fusion")
    assert server.map_fusion(bad)                 # warn-and-proceed
    assert not server.candidate_log[-1]["ok"], server.candidate_log[-1]
    assert server.constraint_kinds.count("fusion") == n_fus + 1

    server2 = port_server(port_clients(world), reject_bad_candidates=True)
    assert server2.map_fusion(true_msg(world, 3, 3))
    n2 = server2.constraint_kinds.count("fusion")
    assert not server2.map_fusion(bad)
    assert server2.constraint_kinds.count("fusion") == n2


def test_evaluate_residuals_by_type(world):
    server = port_server(port_clients(world), verbose=True)
    assert server.map_fusion(true_msg(world, 3, 3))
    res = server.evaluate_residuals()
    assert len(res["fusion"]) == server.constraint_kinds.count("fusion") >= 1
    assert len(res["submap_rp"]) == \
        server.constraint_kinds.count("submap_rp")
    assert max(res["fusion"]) < 1.5
    assert "residuals" in server.optimize()


def test_auto_global_mesh_event(world):
    server = port_server(port_clients(world),
                         publish_global_mesh_on_update=True,
                         solver=fs.pg.SolverConfig(iterations=1),
                         registration_weight=0.0)
    server.map_fusion(true_msg(world, 3, 3))
    coarse = vx.VoxelGridSpec(voxel_size=0.2, voxels_per_side=8,
                              grid_dim=16, max_blocks=512, truncation=0.6)
    n = len(server.clients)
    for _ in range(4 * n):
        server.time_line_update()
    assert server.generate_global_mesh_event(mesh_spec=coarse) is None
    server.get_final_global_mesh(None, mesh_spec=coarse)
    for _ in range(4 * n - 1):
        server.time_line_update()
        assert server.generate_global_mesh_event(mesh_spec=coarse) is None
    server.time_line_update()
    out = server.generate_global_mesh_event(mesh_spec=coarse)
    assert out is not None and out[1].shape[0] > 0
    assert server.global_mesh_need_update == 0
    server.global_mesh_need_update = 11 * n
    assert server.generate_global_mesh_event(mesh_spec=coarse) is not None
    server2 = port_server(port_clients(world))
    server2.global_mesh_initialized = True
    server2.global_mesh_need_update = 4 * n
    assert server2.generate_global_mesh_event() is None


def test_save_pose_history_all_clients(world, tmp_path):
    clients = port_clients(world)
    server = port_server(clients)
    server.map_fusion(true_msg(world, 3, 3))
    path = server.save_pose_history(str(tmp_path))
    assert path.endswith("coxgraph_server_traj.txt")
    stamps, poses = read_tum_trajectory(path)
    n0 = len(clients[0].get_pose_history()[0])
    n1 = len(clients[1].get_pose_history()[0])
    assert len(stamps) == n0 + n1
    idx = np.clip((stamps[n0:] / DT).round().astype(int), 0,
                  ts.N_FRAMES - 1)
    gt = np.asarray(world[1][1])[idx]
    err = np.linalg.norm(poses[n0:, 4:7] - gt[:, 4:7], axis=-1)
    assert np.median(err) < 0.15, np.median(err)


def test_three_client_fusion_chain():
    """Client 2 never closes a loop with the reference client: its frame
    alignment propagates through the client-frame graph."""
    jscene = ts.syn.default_scene()
    scene = syn.default_scene(CPU)
    X = [geo.identity_np()] + [geo.from_xyzyaw(torch.tensor(p)).numpy()
                               for p in ([1.0, -0.5, 0.0, 0.6],
                                         [-0.8, 0.7, 0.0, -0.4])]
    trajs = [np.asarray(ts.syn.orbit_trajectory(
        ts.N_FRAMES, jscene.room_center, radius=2.3, sweep=0.7 * np.pi,
        start_angle=a)) for a in (0.0, 0.5 * np.pi, 1.0 * np.pi)]
    clients = []
    for cid in range(3):
        state = sm.create_mapper(CFG, CPU)
        for i in range(ts.N_FRAMES):
            T = torch.from_numpy(trajs[cid][i])
            d, c = syn.render_depth(scene, CFG.intrinsics, T)
            T_odom = torch.from_numpy(geo.compose_np(geo.inverse_np(X[cid]),
                                                     trajs[cid][i]))
            sm.mapper_step(CFG, state, d, c, T_odom, i * DT)
        clients.append(InProcessClient(cid, CFG, state))
    server = port_server(clients)
    for (a, ta, b, tb) in ((0, 3, 1, 3), (1, 5, 2, 4)):
        T = geo.relative_np(trajs[a][ta], trajs[b][tb])
        assert server.map_fusion(fs.MapFusionMsg(a, ta * DT, b, tb * DT, T))
    for cid in (1, 2):
        err = geo.se3_log(geo.relative(torch.from_numpy(server.T_G_cli[cid]),
                                       torch.from_numpy(X[cid])))
        assert float(err.norm()) < 0.2, (cid, err)


def test_constraint_pool_saturation_warns_and_counts(world):
    server = port_server(port_clients(world), max_constraints=3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        server.collect_all_submaps()
        for cid in server.clients:
            server.fused[cid] = True
        server.collect_all_submaps()
        saturated = [x for x in w
                     if "constraint pool saturated" in str(x.message)]
    assert server.dropped_constraints > 0
    assert len(saturated) == server.dropped_constraints
    assert len(server.constraint_kinds) == 3
    assert int(server.constraints.valid.sum()) == 3
    assert server.constraints.num_dropped() == 0
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("ignore")
        assert server.map_fusion(true_msg(world, 4, 4)) is False
    res = server.evaluate_residuals()
    assert all(np.isfinite(v) for vs in res.values() for v in vs)


def test_height_pool_saturation_warns(world):
    server = port_server(port_clients(world), height_prior_stddev=0.1)
    cap = server.heights.capacity
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for k in range(cap + 3):
            server._add_height(k % 4, 0.0)
        saturated = [x for x in w
                     if "height-prior pool saturated" in str(x.message)]
    assert server.dropped_heights == 3 == len(saturated)
    assert int(server.heights.count) == cap


def test_submap_pool_saturation_keeps_serving(world):
    clients = port_clients(world)
    server = port_server(clients, max_submaps=3)
    for cid in server.clients:
        server.fused[cid] = True
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        server.collect_all_submaps()
        saturated = [x for x in w
                     if "server submap pool saturated" in str(x.message)]
    assert len(server.submaps) == 3
    assert server.dropped_submaps > 0
    assert len(saturated) == server.dropped_submaps
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("ignore")
        assert server.map_fusion(true_msg(world, 7, 7)) is False
    h0 = clients[0].get_all_submaps()[0]
    assert server._add_submap(h0) == server.cli_ser[
        (h0.client_id, h0.client_submap_id)]
    assert server.state_query()["n_submaps"] == 3
    assert len(server.pose_history(0)[0]) > 0
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("ignore")
        _, verts, _ = server.get_final_global_mesh()
    assert verts.shape[0] > 0
    assert torch.isfinite(server._poses()).all()


def test_optimize_uses_cached_geometry(world, monkeypatch):
    """Geometry is cached per submap version (one batched read at solve or
    query time, never on the fusion path), poses are host numpy, and the
    fusion's candidate check fills the cache the solve reuses."""
    from coxgraph_tpu_torch.server import global_opt

    server = port_server(port_clients(world))
    assert server.map_fusion(true_msg(world, 3, 3))
    sa = server.candidate_log[-1]["sa"]
    assert server.submaps[sa].reg_cache is not None
    server.collect_all_submaps()
    server._ensure_geometry()
    for s in server.submaps:
        assert s.aabb is not None and s.aabb.shape == (2, 3)
        assert s.n_blocks > 0
        assert isinstance(s.T_G_submap, np.ndarray)
        assert isinstance(s.T_cli_submap, np.ndarray)

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("submap geometry recomputed during optimize")

    monkeypatch.setattr(global_opt, "submap_geometry", boom)
    assert server.optimize()["n_registration_pairs"] > 0
    q = server.state_query()
    assert len(q["aabbs"]) == len(server.submaps)
    assert q["resources"]["rss_mb"] > 1.0
    assert q["resources"]["cpu_pct"] >= 0.0


def _mesh_messages(jserver):
    """Client-pushed meshes for both servers → {(cid, csid): packed
    bytes}: JAX's MeshWithHistory of client 0's first held submap
    (encoded from the JAX server's pulled layer), seeded messages for
    the other held submaps, and one for a submap neither server holds
    (skipped by the combination)."""
    from coxgraph_tpu.comm import mesh_comm as jmc

    keys = sorted(jserver.cli_ser)
    s = jserver.submaps[jserver.cli_ser[keys[0]]]
    out = {keys[0]: jmc.encode_submap_mesh(
        ts.SPEC, s.layer, np.asarray(s.hist_stamps),
        np.asarray(s.hist_poses), ts.CFG.intrinsics, client_id=keys[0][0],
        submap_id=keys[0][1]).pack()}
    rng = np.random.RandomState(5)
    for cid, csid in keys[1:] + [(1, 99)]:
        nv, nf = rng.randint(3, 40), rng.randint(1, 30)
        out[(cid, csid)] = jmc.MeshWithHistory(
            cid, csid, 0.0, 1.0, rng.uniform(-2, 2, 3).astype(np.float32),
            float(rng.uniform(1e-4, 1e-3)),
            rng.randint(0, 4000, (nv, 3)).astype(np.uint16),
            rng.randint(0, 256, (nv, 3)).astype(np.uint8),
            rng.randint(0, nv, (nf, 3)).astype(np.uint32),
            np.zeros((nf, 1, 2), np.uint16), np.zeros(1),
            np.array([[1, 0, 0, 0, 0, 0, 0]], np.float32)).pack()
    return out


def test_combined_submap_mesh_matches_jax(sequence):
    """One set of client-pushed mesh messages into the JAX server and the
    port's after the fusion sequence: publish_submap_meshes gives back the
    same messages, and combined_submap_mesh in both colour modes gives
    faces and colours exact and each vertex within the file's pose
    tolerance (1e-3 m + 1e-3 rad times its distance from its submap's
    origin; observed at most 7.1e-5 m, 2.7% of the bound)."""
    from coxgraph_tpu.comm import mesh_comm as jmc
    from coxgraph_tpu_torch.comm import mesh_comm

    _, _, jserver, pserver = sequence
    msgs = _mesh_messages(jserver)
    assert len(msgs) >= 3 and (1, 99) not in jserver.cli_ser
    for (cid, csid), buf in msgs.items():
        jserver.add_submap_mesh(cid, csid, jmc.MeshWithHistory.unpack(buf))
        pserver.add_submap_mesh(cid, csid,
                                mesh_comm.MeshWithHistory.unpack(buf))
    try:
        jpub, ppub = (s.publish_submap_meshes() for s in (jserver, pserver))
        assert set(ppub) == set(jpub) == set(msgs)
        for key, buf in msgs.items():
            assert ppub[key].pack() == jpub[key].pack() == buf
        held = [mesh_comm.MeshWithHistory.unpack(msgs[k]).vertices()
                for k in sorted(msgs) if k in jserver.cli_ser]
        reach = np.linalg.norm(np.concatenate(held), axis=1)
        for mode in (0, 1):
            jv, jf, jc = jserver.combined_submap_mesh(color_mode=mode)
            pv, pf, pc = pserver.combined_submap_mesh(color_mode=mode)
            assert pf.dtype == jf.dtype and pc.dtype == jc.dtype
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(pc, jc)
            assert pv.dtype == jv.dtype and pv.shape == (reach.shape[0], 3)
            assert jv.shape == pv.shape and jf.shape[0] > 100
            err = np.linalg.norm(pv - jv, axis=1)
            assert (err <= 1e-3 + 1e-3 * reach).all(), err.max()
        assert np.unique(pc.reshape(-1, 3), axis=0).tolist() == [
            [0, 255, 0], [255, 0, 0]]             # mode 1: two clients
    finally:
        jserver.mesh_collection.clear()
        pserver.mesh_collection.clear()


@pytest.mark.parametrize("call", ["add_submap_mesh", "publish_submap_meshes",
                                  "combined_submap_mesh", "device_mesh"])
def test_unported_pieces_raise(world, call):
    """Every piece these cases once found raising is ported now. The
    client-pushed mesh calls: a mesh message is cached, published back
    and combined in the global frame (a mesh whose submap the server does
    not hold yet is skipped). The sharded final mesh (parallel/, ROADMAP
    queue 1 item 5): over a world-size-1 group it returns as many
    triangles as the unsharded call (test_sharded_final_mesh_matches_
    unsharded holds the triangles themselves)."""
    from coxgraph_tpu_torch.comm import mesh_comm
    from coxgraph_tpu_torch.parallel import fleet as fl

    server = port_server(port_clients(world))
    if call == "device_mesh":
        with multihost.single_process(CPU):
            _, v, _ = server.get_final_global_mesh(
                device_mesh=fl.make_robot_mesh(device=CPU))
        _, vs, _ = server.get_final_global_mesh()
        assert v.shape == vs.shape and v.shape[0] > 500
        return
    h = server.clients[0].get_submap_by_time(0.0)
    msg = mesh_comm.encode_submap_mesh(SPEC, h.layer, h.hist_stamps,
                                       h.hist_poses, CFG.intrinsics,
                                       client_id=0, submap_id=0)
    server.add_submap_mesh(0, 0, msg)
    assert server.publish_submap_meshes() == {(0, 0): msg}
    verts, faces, cols = server.combined_submap_mesh()
    assert verts.shape[0] == 0            # submap (0, 0) not pulled yet
    assert server.map_fusion(true_msg(world, 0, 0))
    verts, faces, cols = server.combined_submap_mesh()
    sid = server.cli_ser[(0, 0)]
    np.testing.assert_allclose(
        verts, geo.transform_points_np(server.submaps[sid].T_G_submap,
                                       msg.vertices()), atol=1e-6)
    np.testing.assert_array_equal(faces, msg.faces)
    np.testing.assert_array_equal(cols, msg.vcolors)


def test_server_needs_a_device_or_the_card(monkeypatch, world):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.CoxgraphServer(fs.ServerConfig(spec=SPEC), port_clients(world))


def test_server_config_carries_across():
    jcfg = dataclasses.replace(
        ts.fs.ServerConfig(), spec=ts.SPEC, max_submaps=48,
        registration=ts.fs.reg.RegistrationConfig(max_points=1024,
                                                  iterations=10),
        solver=ts.fs.pg.SolverConfig(iterations=7), async_pgo=True)
    cfg = interop.config_from(jcfg)
    assert isinstance(cfg, fs.ServerConfig)
    assert cfg.registration == fs.reg.RegistrationConfig(max_points=1024,
                                                         iterations=10)
    assert cfg.solver.iterations == 7 and cfg.async_pgo
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
