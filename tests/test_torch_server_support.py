"""The server tier's support modules in the port vs the JAX package:
eval.metrics, eval.export, ops.mesh_post, synthetic.noisy_odometry,
submap_mapper.mapper_step, voxel.memory_size_bytes, runtime.ResourceSampler,
the client interface's two serving paths, frontends.vio_interface and
mapper.map_server.

Tolerances: metrics, export and mesh_post are the same host numpy code:
equal outputs and equal bytes. noisy_odometry with JAX's noise fed in:
poses within 1e-5 (observed 1.2e-6; the port composes on the host's f32
torch, JAX in XLA). mapper_step and the VIO stream: the mapper states to
tests/test_torch_mapper.py's standard. The client interface: the JAX
client's device path, the port's device path and the port's host mirror
serve the same handles (integers and stamps exact, poses within 1e-6).
MapServer at generic odom poses (one change of frame moves the orbit off
the voxel lattice, see test_torch_server.py): integers exact, merged
TSDF and ESDF within 1e-4 (observed 6e-6), traversability masks equal."""

import dataclasses
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_map_server as tms
import test_mesh_post as tmp
from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.eval import export as jexport
from coxgraph_tpu.eval import metrics as jmetrics
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.frontends import vio_interface as jvio
from coxgraph_tpu.mapper import map_server as jms
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import esdf as jesdf
from coxgraph_tpu.ops import mesh_post as jpost
from coxgraph_tpu.server.client_interface import InProcessClient as JClient
from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.eval import export, metrics
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.frontends import vio_interface as vio
from coxgraph_tpu_torch.mapper import map_server as pms
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import mesh_post
from coxgraph_tpu_torch.server.client_interface import InProcessClient
from coxgraph_tpu_torch.utils import interop
from test_torch_mapper import JCFG, _assert_state_matches, _frames
from test_torch_mesh import one_thread  # noqa: F401

CPU = torch.device("cpu")
CFG = interop.config_from(JCFG)
# one generic change of the odom frame (off the voxel lattice)
FRAME = np.concatenate([
    np.asarray(jgeo.so3_exp(jnp.array([0.031, -0.017, 0.113]))),
    [0.0123, -0.0371, 0.0217]]).astype(np.float32)


def _traj(rng, n=40):
    """A seeded wandering trajectory (n, 7) with stamps (n,)."""
    w = rng.normal(size=(n, 3)) * 0.3
    q = np.asarray(jgeo.so3_exp(jnp.asarray(w, jnp.float32)))
    t = np.cumsum(rng.normal(size=(n, 3)) * 0.2, axis=0)
    return np.arange(n) * 0.1, np.concatenate([q, t], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# eval.metrics, eval.export, ops.mesh_post: the same outputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align", [False, True])
def test_metrics_match_jax(align):
    rng = np.random.default_rng(3)
    se, pe = _traj(rng)
    sg, pg_ = _traj(rng)
    sg = sg + rng.uniform(-0.03, 0.03, sg.shape)
    sg.sort()
    for fn in ("associate",):
        a, b = getattr(jmetrics, fn)(se, sg), getattr(metrics, fn)(se, sg)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert jmetrics.ate_rmse(se, pe, sg, pg_, align=align) == \
        metrics.ate_rmse(se, pe, sg, pg_, align=align)
    assert jmetrics.rpe(se, pe, sg, pg_, delta=0.5) == \
        metrics.rpe(se, pe, sg, pg_, delta=0.5)
    for got, want in zip(metrics.umeyama_alignment(pe[:, 4:], pg_[:, 4:],
                                                   with_scale=align),
                         jmetrics.umeyama_alignment(pe[:, 4:], pg_[:, 4:],
                                                    with_scale=align)):
        np.testing.assert_array_equal(got, want)


def test_export_writes_the_same_bytes(tmp_path):
    rng = np.random.default_rng(4)
    soup = tmp.icosphere_soup(2, jitter=0.01)
    cols = rng.random(soup.shape).astype(np.float32)
    for name, args in (("write_ply", (soup, cols)),
                       ("write_ply", (soup, None))):
        a, b = tmp_path / f"j_{name}.ply", tmp_path / f"p_{name}.ply"
        assert getattr(jexport, name)(str(a), *args) == \
            getattr(export, name)(str(b), *args)
        assert filecmp.cmp(a, b, shallow=False)
        assert export.read_ply_counts(str(b)) == \
            jexport.read_ply_counts(str(a))
    m = mesh_post.connect_soup(soup, cols)
    a, b = tmp_path / "ji.ply", tmp_path / "pi.ply"
    jexport.write_ply_indexed(str(a), m.vertices, m.faces, m.colors)
    export.write_ply_indexed(str(b), m.vertices, m.faces, m.colors)
    assert filecmp.cmp(a, b, shallow=False)
    stamps, poses = _traj(rng)
    a, b = tmp_path / "j.tum", tmp_path / "p.tum"
    jexport.write_tum_trajectory(str(a), stamps, poses)
    export.write_tum_trajectory(str(b), stamps, poses)
    assert filecmp.cmp(a, b, shallow=False)
    for got, want in zip(export.read_tum_trajectory(str(b)),
                         jexport.read_tum_trajectory(str(a))):
        np.testing.assert_array_equal(got, want)


def _mesh_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    if a.colors is None:
        assert b.colors is None
    else:
        np.testing.assert_array_equal(a.colors, b.colors)


@pytest.mark.parametrize("with_colors", [False, True])
def test_mesh_post_matches_jax(with_colors):
    rng = np.random.default_rng(5)
    soup = tmp.icosphere_soup(3, jitter=0.02, seed=5)
    cols = rng.random(soup.shape).astype(np.float32) if with_colors \
        else None
    pm, jm = mesh_post.connect_soup(soup, cols), jpost.connect_soup(soup,
                                                                    cols)
    _mesh_equal(pm, jm)
    _mesh_equal(mesh_post.merge_close_vertices(pm, 0.1),
                jpost.merge_close_vertices(jm, 0.1))
    np.testing.assert_array_equal(
        mesh_post.remove_duplicated_triangles(np.concatenate([pm.faces,
                                                              pm.faces])),
        jpost.remove_duplicated_triangles(np.concatenate([jm.faces,
                                                          jm.faces])))
    _mesh_equal(mesh_post.taubin_smooth(pm, 10), jpost.taubin_smooth(jm, 10))
    _mesh_equal(mesh_post.simplify_vertex_clustering(pm, 0.2),
                jpost.simplify_vertex_clustering(jm, 0.2))
    _mesh_equal(mesh_post.postprocess(soup, cols, taubin_iterations=20),
                jpost.postprocess(soup, cols, taubin_iterations=20))


# ---------------------------------------------------------------------------
# Small dependencies
# ---------------------------------------------------------------------------


def _jax_noise(key, n, rot_std, trans_std):
    """The noise jax's noisy_odometry draws (its own key schedule)."""
    keys = jax.random.split(key, n - 1)
    return np.asarray(jax.vmap(lambda k: jnp.concatenate([
        jax.random.normal(k, (3,)) * rot_std,
        jax.random.normal(jax.random.fold_in(k, 1), (3,)) * trans_std]))(
            keys))


def test_noisy_odometry_with_jax_noise_matches_jax():
    scene = jsyn.default_scene()
    traj = jsyn.orbit_trajectory(40, scene.room_center, radius=2.4,
                                 sweep=1.2 * jnp.pi)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jsyn.noisy_odometry(key, traj, rot_std=0.002,
                                          trans_std=0.005))
    noise = _jax_noise(key, 40, 0.002, 0.005)
    got = syn.compose_odometry(torch.from_numpy(np.asarray(traj)),
                               torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the port's own draw: seeded, and of the stated scale
    t = torch.from_numpy(np.asarray(traj))
    a = syn.noisy_odometry(torch.Generator().manual_seed(7), t)
    b = syn.noisy_odometry(torch.Generator().manual_seed(7), t)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    z = syn.odometry_noise(torch.Generator().manual_seed(0), 20000,
                           0.002, 0.005)
    np.testing.assert_allclose(z.std(0).numpy(), [0.002] * 3 + [0.005] * 3,
                               rtol=0.05)


def test_mapper_step_matches_jax():
    depths, colors, traj = _frames(5)
    jstate = jsm.create_mapper(JCFG)
    pstate = sm.create_mapper(CFG, CPU)
    for i in range(5):
        jstate, js = jsm.mapper_step(JCFG, jstate, jnp.asarray(depths[i]),
                                     jnp.asarray(colors[i]),
                                     jnp.asarray(traj[i]), i * 0.1)
        out, ps = sm.mapper_step(CFG, pstate, torch.from_numpy(depths[i]),
                                 torch.from_numpy(colors[i]),
                                 torch.from_numpy(traj[i]), i * 0.1)
        assert out is pstate and ps == js
    _assert_state_matches(jstate, pstate)


def test_memory_size_bytes_matches_jax():
    for spec in (JCFG.spec, jvx.VoxelGridSpec()):
        jl = jvx.create_tsdf_layer(spec)
        pl = vx.create_tsdf_layer(interop.config_from(spec), "meta")
        assert vx.memory_size_bytes(pl) == jvx.memory_size_bytes(jl)


def test_resource_sampler():
    s = runtime.ResourceSampler()
    first = s.sample()
    assert first["cpu_pct"] == 0.0 and first["rss_mb"] > 1.0
    assert s.sample()["cpu_pct"] >= 0.0
    s.start(rate_hz=200.0)
    import time
    time.sleep(0.05)
    out = s.stop()
    assert out["n"] >= 2 and out["rss_mb_max"] > 1.0
    assert set(out) == {"n", "cpu_pct_mean", "cpu_pct_max", "rss_mb_max"}


# ---------------------------------------------------------------------------
# The client interface: JAX device path ≡ port device path ≡ port mirror
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def robot():
    """A JAX client and two port clients of one 5-frame stream: the port's
    first from the JAX state (device path), the second fed by a HostMapper
    with host poses (mirror path)."""
    depths, colors, traj = _frames(5)
    jstate = jsm.create_mapper(JCFG)
    for i in range(5):
        jstate, _ = jsm.mapper_step(JCFG, jstate, jnp.asarray(depths[i]),
                                    jnp.asarray(colors[i]),
                                    jnp.asarray(traj[i]), i * 0.1)
    jc = JClient(0, JCFG, jstate)
    dc = interop.client_from(jc, CPU)
    hm = sm.HostMapper(CFG, device=CPU)
    for i in range(5):
        hm.step(torch.from_numpy(depths[i]), torch.from_numpy(colors[i]),
                traj[i], i * 0.1)
    mc = InProcessClient(0, CFG, hm.state)
    mc.mapper = hm
    assert mc._mirror() is hm and dc._mirror() is None
    return jc, dc, mc


def _handle_equal(a, b, atol=1e-6):
    assert (a.client_id, a.client_submap_id) == (b.client_id,
                                                 b.client_submap_id)
    assert abs(a.start_time - b.start_time) < 1e-6
    assert abs(a.end_time - b.end_time) < 1e-6
    np.testing.assert_allclose(np.asarray(b.hist_stamps), a.hist_stamps,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(b.T_cli_submap), a.T_cli_submap,
                               atol=atol, rtol=0)
    np.testing.assert_allclose(np.asarray(b.hist_poses), a.hist_poses,
                               atol=atol, rtol=0)


@pytest.mark.parametrize("path", ["device", "mirror"])
def test_client_serving_matches_jax(robot, path):
    jc, dc, mc = robot
    c = dc if path == "device" else mc
    assert c.timeline() == pytest.approx(jc.timeline(), abs=1e-6)
    for t in (0.0, 0.15, 0.35, 9.0):
        hj, hp = jc.get_submap_by_time(t), c.get_submap_by_time(t)
        assert (hj is None) == (hp is None) and c.req_state == jc.req_state
        if hj is not None:
            _handle_equal(hp, hj)
            assert hp.layer.sdf.data_ptr() != \
                c.state.collection.layers.sdf.data_ptr()
    for hp, hj in zip(c.get_all_submaps(), jc.get_all_submaps()):
        _handle_equal(hp, hj)
        for name in ("block_index", "block_coords", "num_blocks"):
            np.testing.assert_array_equal(
                getattr(hp.layer, name).numpy(),
                np.asarray(getattr(hj.layer, name)))
    assert c.sent_submaps == jc.sent_submaps
    assert c.bytes_sent == jc.bytes_sent
    (sj, pj), (sp, pp) = jc.get_pose_history(), c.get_pose_history()
    np.testing.assert_allclose(sp, np.asarray(sj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pp, np.asarray(pj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c.lookup_pose_in_submap(1, 0.35),
                               jc.lookup_pose_in_submap(1, 0.35),
                               atol=1e-6, rtol=0)


def test_served_layer_is_a_copy(robot):
    """The robot integrates in place; a layer served before keeps its
    values."""
    _, dc, _ = robot
    h = dc.get_submap_by_time(0.35)
    before = h.layer.weight.clone()
    pool = dc.state.collection.layers.weight
    saved = pool.clone()
    pool.add_(1.0)
    try:
        torch.testing.assert_close(h.layer.weight, before, rtol=0, atol=0)
    finally:
        pool.copy_(saved)


def test_pose_updates_and_deltas_match_jax():
    depths, colors, traj = _frames(5)
    jstate = jsm.create_mapper(JCFG)
    for i in range(5):
        jstate, _ = jsm.mapper_step(JCFG, jstate, jnp.asarray(depths[i]),
                                    jnp.asarray(colors[i]),
                                    jnp.asarray(traj[i]), i * 0.1)
    jc = JClient(0, JCFG, jstate)
    pc = interop.client_from(jc, CPU)
    for c in (jc, pc):
        assert len(c.pose_update_deltas()) == 2
        assert c.pose_update_deltas() == []
    upd = [(1, geo.compose_np(np.asarray(traj[3]), FRAME))]
    jc.apply_pose_updates(upd)
    pc.apply_pose_updates(upd)
    np.testing.assert_array_equal(
        pc.state.collection.T_odom_submap.numpy(),
        np.asarray(jc.state.collection.T_odom_submap))
    assert pc.pose_update_deltas() == [] == jc.pose_update_deltas()
    for c in (jc, pc):
        assert c.finish_map() and not c.finish_map()
        c.toggle_mapping(True)
        assert not c.mapping_enabled
    np.testing.assert_allclose(
        pc.state.collection.T_odom_submap.numpy(),
        np.asarray(jc.state.collection.T_odom_submap), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# VIOInterface
# ---------------------------------------------------------------------------


def test_pose_from_orbslam_matches_jax():
    import test_vio_interface as tv

    rng = np.random.default_rng(6)
    for k in range(4):
        want = np.asarray(jgeo.from_xyzyaw(jnp.asarray(
            rng.uniform(-1, 1, 4), jnp.float32)))
        T = tv.orb_matrix_from_pose(jnp.asarray(want))
        np.testing.assert_allclose(vio.pose_from_orbslam(T),
                                   np.asarray(jvio.pose_from_orbslam(T)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(vio.pose_from_orbslam(np.eye(4)),
                               geo.identity_np(), atol=1e-6)


class _Server:
    """Counts the VIO facade's calls into a server."""

    def __init__(self):
        self.ticks, self.fusions = 0, []

    def time_line_update(self):
        self.ticks += 1

    def need_to_fuse(self, a, b, t):
        return t > 1.0

    def map_fusion(self, mf):
        self.fusions.append(mf)
        return True


def test_vio_stream_matches_jax():
    depths, colors, traj = _frames(5)
    jv = jvio.VIOInterface(0, JCFG, JClient(0, JCFG,
                                            jsm.create_mapper(JCFG)))
    server = _Server()
    pc = InProcessClient(0, CFG, sm.create_mapper(CFG, CPU))
    pv = vio.VIOInterface(0, CFG, pc, server)
    for i in range(5):
        T4 = np.asarray(jgeo.to_matrix(jnp.asarray(traj[i])))
        jv.update_pose_matrix(T4, i * 0.1, jnp.asarray(depths[i]),
                              jnp.asarray(colors[i]), orbslam_axes=False)
        pv.update_pose_matrix(T4, i * 0.1, torch.from_numpy(depths[i]),
                              torch.from_numpy(colors[i]),
                              orbslam_axes=False)
    _assert_state_matches(jv.client.state, pc.state)
    assert server.ticks == 5
    np.testing.assert_allclose(pv.frames()[("odom", "sensor")],
                               np.asarray(jv.frames()[("odom", "sensor")]),
                               atol=1e-6, rtol=0)
    pv.T_imu_sensor = jv.T_imu_sensor = np.asarray(
        jgeo.from_xyzyaw(jnp.asarray([0.1, 0.0, 0.05, 0.2])))
    for key in (("odom", "imu"), ("imu", "sensor")):
        np.testing.assert_allclose(pv.frames()[key],
                                   np.asarray(jv.frames()[key]), atol=1e-6,
                                   rtol=0)
    # toggle_mapping gates integration, not pose tracking
    pv.toggle_mapping(False)
    n = int(pc.state.frame_count)
    T0 = traj[0]
    pv.update_pose(T0, 0.6, torch.from_numpy(depths[0]), None)
    assert int(pc.state.frame_count) == n and pv.T_odom_latest is T0
    # need-to-fuse answers are the server's, cached per client pair
    assert not pv.need_to_fuse(1, 0, 0.5)
    assert pv._need_to_fuse_cache[(0, 1)] is False
    assert pv.need_to_fuse(0, 1, 2.0)
    assert pv.publish_loop_closure(0, 0.1, 1, 0.2, geo.identity_np())
    assert server.fusions[-1].to_time == 0.2


# ---------------------------------------------------------------------------
# MapServer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def map_servers():
    """test_map_server's clip, integrated in an odom frame moved off the
    voxel lattice, through the JAX MapServer and the port's."""
    scene = jsyn.default_scene()
    traj = jsyn.orbit_trajectory(8, scene.room_center, radius=2.5,
                                 sweep=jnp.pi)
    ms_cfg = jms.MapServerConfig(esdf=jesdf.EsdfConfig(max_distance=1.0),
                                 robot_radius=0.4)
    state = jsm.create_mapper(tms.CFG)
    jserver = jms.MapServer(tms.CFG, ms_cfg)
    frame = jnp.asarray(FRAME)
    for i in range(8):
        d, c = jsyn.render_depth(scene, tms.CFG.intrinsics, traj[i])
        state, _ = jsm.mapper_step(tms.CFG, state, d, c,
                                   jgeo.compose(frame, traj[i]), i * 0.1)
        jserver.add_keyframe(i * 0.1)
    pserver = pms.MapServer(interop.config_from(tms.CFG),
                            interop.config_from(ms_cfg))
    for i in range(8):
        pserver.add_keyframe(i * 0.1)
    return (jserver, state.collection, pserver,
            interop.mapper_state_from(state, CPU).collection)


def test_map_server_merged_maps_match_jax(map_servers):
    jserver, jcol, pserver, pcol = map_servers
    jt, pt = jserver.merged_tsdf(jcol), pserver.merged_tsdf(pcol)
    got = interop.layer_to_numpy(pt)
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jt, name)))
    for name in ("sdf", "weight", "color"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jt, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    je, pe = jserver.merged_esdf(jcol), pserver.merged_esdf(pcol)
    for name in ("observed", "block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(getattr(pe, name).numpy(),
                                      np.asarray(getattr(je, name)))
    np.testing.assert_allclose(pe.dist.numpy(), np.asarray(je.dist),
                               atol=1e-4, rtol=0)
    (jp, jm), (pp, pm) = (jserver.traversability(jcol),
                          pserver.traversability(pcol))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5,
                               rtol=0)
    # the cache holds until a pose update
    assert pserver.merged_esdf(pcol) is pe
    pserver.notify_pose_update()
    assert pserver.merged_esdf(pcol) is not pe


@pytest.mark.parametrize("keyframes", [[0.1], [], [0.0, 0.2, 0.31]])
def test_keyframe_history_matches_jax(map_servers, keyframes):
    jserver, jcol, pserver, pcol = map_servers
    jserver._keyframe_stamps = list(keyframes)
    pserver._keyframe_stamps = list(keyframes)
    for k in range(int(jcol.num_submaps)):
        (sj, pj), (sp, pp) = (jserver.keyframe_history(jcol, k),
                              pserver.keyframe_history(pcol, k))
        np.testing.assert_array_equal(sp, sj)
        np.testing.assert_array_equal(pp, pj)


def test_map_server_submap_mesh_msg_not_ported(map_servers):
    """Ported now: the map server's mesh message of each submap ≡ the JAX
    map server's, byte for byte, from the same triangle soup (the soups
    themselves are held to each other in tests/test_torch_mesh.py)."""
    from coxgraph_tpu.ops import mesh as jmesh
    from coxgraph_tpu_torch.comm import mesh_comm

    jserver, jcol, pserver, pcol = map_servers
    for k in range(int(jcol.num_submaps)):
        soup = jmesh.extract_mesh(jserver.cfg.spec,
                                  jsm.get_layer(jcol.layers, k))
        want = jserver.submap_mesh_msg(jcol, k, tms.CFG.intrinsics,
                                       client_id=1, soup=soup)
        got = pserver.submap_mesh_msg(pcol, k, pserver.cfg.intrinsics,
                                      client_id=1, soup=soup)
        assert isinstance(got, mesh_comm.MeshWithHistory)
        assert got.pack() == want.pack() and got.submap_id == k


def test_small_two_client_world_matches_jax():
    """eval.demos.small_two_client_world (the world the GPU checks build)
    ≡ test_server.build_two_clients, to the mapper standard."""
    import test_server as ts
    from coxgraph_tpu_torch.eval import demos

    _, _, _, jclients = ts.build_two_clients()
    trajs, X, clients = demos.small_two_client_world(CPU)
    cfg, scfg = demos.small_world_configs()
    assert cfg == interop.config_from(ts.CFG)
    assert scfg == interop.config_from(ts.make_server(jclients).cfg)
    for jc, pc in zip(jclients, clients):
        _assert_state_matches(jc.state, pc.state)
    mf = ts.true_fusion_msg([jnp.asarray(t) for t in trajs], 3, 5)
    np.testing.assert_allclose(demos.true_fusion(trajs, 3, 5).T_from_to,
                               np.asarray(mf.T_from_to), atol=1e-6, rtol=0)


def test_submap_handle_carries_across(robot):
    jc, dc, _ = robot
    h = interop.submap_handle_from(jc.get_submap_by_time(0.35), CPU)
    _handle_equal(h, dc.get_submap_by_time(0.35), atol=0)
    for name in ("sdf", "weight", "color", "block_index", "block_coords",
                 "num_blocks"):
        torch.testing.assert_close(
            getattr(h.layer, name),
            getattr(dc.get_submap_by_time(0.35).layer, name), rtol=0, atol=0)


def test_two_robot_demo_runs_end_to_end_on_small_pools(tmp_path):
    """eval.demos.TwoRobotDemo's plumbing on the CPU with small pools (the
    demo's own pools are for the card): every frame integrated, the
    detector fed, the isolated final mesh written, the pose histories and
    byte counts reported."""
    from coxgraph_tpu_torch.eval import demos

    cfg, scfg, dcfg, _ = demos.demo_configs(12, 0.25, 30.0)
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                            max_blocks=512, truncation=0.3)
    cfg = dataclasses.replace(
        cfg, spec=spec, intrinsics=syn.PinholeIntrinsics().scaled(0.125),
        integrator=dataclasses.replace(cfg.integrator,
                                       max_touched_blocks=256))
    scfg = dataclasses.replace(scfg, spec=spec, max_submaps=16)
    dcfg = dataclasses.replace(dcfg, max_keyframes=16)
    demo = demos.TwoRobotDemo(CPU, 12, configs=(
        cfg, scfg, dcfg, dataclasses.replace(spec, max_blocks=1024)))
    res = demo.stream()
    assert res["frames"] == 24 and res["optimize_errors"] == []
    assert [int(c.state.frame_count) for c in demo.clients] == [12, 12]
    assert demo.detector.total_keyframes == 6
    res.update(demo.finish(out=str(tmp_path)))
    assert res["triangles"] > 1000 and res["bytes_shipped"] > 0
    assert export.read_ply_counts(str(tmp_path / "global_mesh.ply"))[1] \
        == res["triangles"]
    assert (tmp_path / "client1.tum").exists()
