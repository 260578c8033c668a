"""The port's host-side modules with the JAX tests' cases:
comm.sync (tests/test_sync.py), comm.tf_broadcast (tests/test_tf_broadcast
.py; also a port listener on a JAX broadcaster), eval.live_view
(tests/test_live_view.py over the port's server, with and without
client-pushed meshes), utils.config (tests/test_checkpoint_config.py's
YAML, equal to the JAX package's configs through utils.interop) and
utils.checkpoint (round trips of a mapper state and a server, a JAX
checkpoint loaded into the port, and a resumed mapper ≡ an uninterrupted
one bit for bit). Everything of the port runs on the CPU."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import test_checkpoint_config as tcc
from coxgraph_tpu.comm import sync as jsync
from coxgraph_tpu.comm import tf_broadcast as jtf
from coxgraph_tpu.utils import checkpoint as jckpt
from coxgraph_tpu.utils import config as jconfig
from coxgraph_tpu_torch.comm import bus as cbus
from coxgraph_tpu_torch.comm import mesh_comm
from coxgraph_tpu_torch.comm.sync import ApproximateTimeSynchronizer
from coxgraph_tpu_torch.comm.tf_broadcast import TfBroadcaster, TfListener
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.eval.demos import free_port
from coxgraph_tpu_torch.eval.live_view import LiveMeshViewer
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.server import fusion_server as fs
from coxgraph_tpu_torch.server.client_interface import InProcessClient
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import checkpoint as ckpt
from coxgraph_tpu_torch.utils import config as cfgutil
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
CFG = interop.config_from(tcc.CFG)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# comm.sync
# ---------------------------------------------------------------------------


def _feed(sync, events):
    out = []
    for ch, t, msg in events:
        out += sync.add(ch, t, msg)
    return out


SYNC_CASES = {
    "pairs_within_slop": (["layer", "cloud"], dict(slop=0.05),
                          [("layer", 1.00, "L1"), ("cloud", 1.02, "C1")]),
    "unpaired_head_discarded": (["a", "b"], dict(slop=0.05),
                                [("a", 1.0, "A1"), ("a", 2.01, "A2"),
                                 ("b", 2.0, "B1")]),
    "in_order_and_no_reuse": (["a", "b"], dict(slop=0.1),
                              [("a", 1.0, "A1"), ("a", 2.0, "A2"),
                               ("a", 3.0, "A3"), ("b", 2.05, "B2"),
                               ("b", 3.0, "B3"), ("b", 1.0, "B1")]),
    "queue_size_bound": (["a", "b"], dict(slop=0.01, queue_size=2),
                         [("a", 1.0, 1), ("a", 2.0, 2), ("a", 3.0, 3),
                          ("b", 1.0, "B")]),
    "three_channels": (["a", "b", "c"], dict(slop=0.1),
                       [("a", 5.0, "A"), ("b", 5.04, "B"),
                        ("c", 4.96, "C")]),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_matches_jax(case):
    channels, kw, events = SYNC_CASES[case]
    got_cb, want_cb = [], []
    got = _feed(ApproximateTimeSynchronizer(
        channels, callback=lambda *m: got_cb.append(m), **kw), events)
    want = _feed(jsync.ApproximateTimeSynchronizer(
        channels, callback=lambda *m: want_cb.append(m), **kw), events)
    assert got == want and got_cb == want_cb
    assert len(got) == {"pairs_within_slop": 1, "unpaired_head_discarded": 1,
                        "in_order_and_no_reuse": 2, "queue_size_bound": 0,
                        "three_channels": 1}[case]


# ---------------------------------------------------------------------------
# comm.tf_broadcast
# ---------------------------------------------------------------------------


@pytest.fixture
def broker():
    port = free_port()
    b = cbus.Broker(port)
    yield port
    b.close()


def test_broadcaster_pushes_at_rate_and_listener_caches(broker):
    tick = {"n": 0}

    def source():
        tick["n"] += 1
        return {("mission_g", "client1_odom"):
                np.array([1, 0, 0, 0, tick["n"], 0, 0], np.float32)}

    bc = TfBroadcaster(broker, source, rate_hz=100.0)
    try:
        lis = TfListener(broker)
        deadline = time.time() + 5.0
        while time.time() < deadline and bc.n_published < 10:
            time.sleep(0.01)
        assert bc.n_published >= 10
        assert lis.spin_once(1000)
        v0 = lis.lookup("mission_g", "client1_odom")[4]
        assert v0 >= 1
        time.sleep(0.2)
        lis.spin_once(1000)
        assert lis.lookup("mission_g", "client1_odom")[4] > v0
        lis.close()
    finally:
        bc.close()


def test_late_listener_and_empty_source(broker):
    frames = {("odom", "sensor"): np.ones(7, np.float32)}
    bc = TfBroadcaster(broker, lambda: frames, rate_hz=50.0)
    time.sleep(0.1)
    bc.close()
    late = TfListener(broker)                    # latched snapshot
    assert late.spin_once(2000)
    np.testing.assert_array_equal(late.lookup("odom", "sensor"),
                                  frames[("odom", "sensor")])
    late.close()
    empty = TfBroadcaster(broker, lambda: {}, rate_hz=200.0)
    time.sleep(0.1)
    assert empty.n_published == 0
    empty.close()


def test_port_listener_reads_a_jax_broadcaster(broker):
    """The TF snapshots are the same bytes in both packages."""
    frames = {("mission_g", "client0_odom"): np.arange(7, dtype=np.float32)}
    bc = jtf.TfBroadcaster(broker, lambda: frames, rate_hz=50.0)
    try:
        lis = TfListener(broker)
        assert lis.spin_once(2000)
        np.testing.assert_array_equal(
            lis.lookup("mission_g", "client0_odom"), np.arange(7))
        lis.close()
    finally:
        bc.close()


# ---------------------------------------------------------------------------
# eval.live_view
# ---------------------------------------------------------------------------


def test_viewer_writes_selfcontained_page(tmp_path):
    v = np.random.default_rng(0).normal(0, 1, (500, 3)).astype(np.float32)
    c = np.full((500, 3), 128, np.uint8)
    viewer = LiveMeshViewer(str(tmp_path), label="unit", max_points=200)
    p = viewer.update(v, c)
    html = open(p).read()
    assert "live map" in html and "http-equiv=\"refresh\"" in html
    assert "src=" not in html                     # no external deps
    meta = json.load(open(os.path.join(str(tmp_path), "live.json")))
    assert 0 < meta["n_points"] <= 200
    viewer.update(v)
    meta = json.load(open(os.path.join(str(tmp_path), "live.json")))
    assert meta["update"] == 1


def _viewer_world():
    """tests/test_live_view.py's world: two robots, one 80×60 frame each
    from opposite sides of the scene, one fusion."""
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                            max_blocks=1024, truncation=0.3)
    cfg = sm.MapperConfig(
        spec=spec, integrator=dataclasses.replace(
            CFG.integrator, max_touched_blocks=256),
        intrinsics=syn.PinholeIntrinsics().scaled(0.125), max_submaps=4,
        max_history=32, submap_interval=100.0)
    scene = syn.default_scene(CPU)
    traj = syn.orbit_trajectory(2, scene.room_center, radius=2.5)
    clients = []
    for cid in range(2):
        d, c = syn.render_depth(scene, cfg.intrinsics, traj[cid])
        st = sm.create_mapper(cfg, CPU)
        sm.start_submap(cfg, st, traj[cid], torch.zeros(()))
        sm.integrate(cfg, st, d, c, traj[cid], torch.zeros(()))
        clients.append(InProcessClient(cid, cfg, st))
    server = fs.CoxgraphServer(
        fs.ServerConfig(spec=spec, max_submaps=8,
                        solver=pg.SolverConfig(iterations=3)), clients, CPU)
    assert server.map_fusion(fs.MapFusionMsg(
        0, 0.0, 1, 0.0, geo.relative(traj[0], traj[1]).numpy()))
    return cfg, clients, server


@pytest.mark.parametrize("pushed", [False, True])
def test_viewer_pulls_from_server(tmp_path, pushed):
    """Without client-pushed meshes the viewer falls back to the final
    global mesh; with them it shows their combination."""
    cfg, clients, server = _viewer_world()
    if pushed:
        for c in clients:
            h = c.get_submap_by_time(0.0)
            server.add_submap_mesh(c.client_id, 0, mesh_comm.encode_submap_mesh(
                cfg.spec, h.layer, h.hist_stamps, h.hist_poses,
                cfg.intrinsics, client_id=c.client_id))
        verts, faces, cols = server.combined_submap_mesh(color_mode=1)
        n = server.mesh_collection[(0, 0)].qverts.shape[0]
        assert (cols[:n] == [255, 0, 0]).all() and (cols[n:] == [0, 255, 0]
                                                     ).all()
        assert faces.max() == verts.shape[0] - 1
        assert set(server.publish_submap_meshes()) == {(0, 0), (1, 0)}
    viewer = LiveMeshViewer(str(tmp_path), max_points=5000)
    # one frame a robot at 2.5 m leaves weights ≤ 0.13: at the viewer's
    # default 0.1 the final mesh keeps 8 triangles in JAX and none in the
    # port (this level world's registration sits on the voxel lattice,
    # ROADMAP queue 3), so the fallback is read at 0.01
    p = viewer.update_from_server(server, min_weight=0.01)
    meta = json.load(open(os.path.join(str(tmp_path), "live.json")))
    assert meta["n_points"] > 20 and os.path.getsize(p) > 2_000


# ---------------------------------------------------------------------------
# utils.config
# ---------------------------------------------------------------------------

YAML = """
voxel: {voxel_size: 0.08, grid_dim: 32, max_blocks: 512}
integrator: {max_touched_blocks: 256}
intrinsics: {width: 80, height: 60, fx: 66.0, fy: 66.0, cx: 39.5, cy: 29.5}
mapper: {max_submaps: 8, submap_interval: 5.0}
server: {refuse_interval: 10.0}
solver: {iterations: 12, huber_delta: 0.4}
features: {max_keypoints: 128}
loop_detector: {min_inliers: 20}
esdf: {max_distance: 3.0}
"""


def test_yaml_config_matches_jax(tmp_path):
    y = tmp_path / "sys.yaml"
    y.write_text(YAML)
    cfgs = cfgutil.load_system_config(str(y))
    want = jconfig.load_system_config(str(y))
    assert set(cfgs) == set(want)
    for key, c in cfgs.items():
        assert c == interop.config_from(want[key]), key
    assert cfgs["mapper"].spec.max_blocks == 512
    assert cfgs["server"].solver.huber_delta == 0.4
    assert "submap_interval: 5.0" in cfgutil.describe(cfgs["mapper"])
    # the JAX description less its integrator's four TPU-only fields,
    # which the port does not have
    tpu_only = {"update_chunk_blocks", "use_pallas", "window_union_blocks",
                "tile_h"}
    jax_lines = jconfig.describe(want["mapper"]).splitlines()
    assert cfgutil.describe(cfgs["mapper"]).splitlines() == [
        ln for ln in jax_lines if ln.split(":")[0].strip() not in tpu_only]
    assert len(jax_lines) - len(tpu_only) == len(
        cfgutil.describe(cfgs["mapper"]).splitlines())
    bad = tmp_path / "bad.yaml"
    bad.write_text("voxel: {voxel_sz: 0.1}")
    with pytest.raises(KeyError):
        cfgutil.load_system_config(str(bad))


def test_information_matrix_matches_jax():
    params = {"x_x": 100.0, "y_y": 100.0, "z_z": 400.0, "yaw_yaw": 400.0,
              "x_y": 10.0}
    M = cfgutil.information_matrix_from_params(params)
    np.testing.assert_array_equal(
        M, jconfig.information_matrix_from_params(params))
    S = cfgutil.sqrt_information(M)
    np.testing.assert_allclose(S.T @ S, M, atol=1e-9)
    M2 = np.zeros((4, 4))
    M2[0, 0] = 1.0
    np.testing.assert_array_equal(cfgutil.sqrt_information(M2),
                                  jconfig.sqrt_information(M2))


# ---------------------------------------------------------------------------
# utils.checkpoint
# ---------------------------------------------------------------------------


def _frames(n):
    scene = syn.default_scene(CPU)
    traj = syn.orbit_trajectory(n, scene.room_center, radius=2.5,
                                sweep=float(np.pi))
    return [(*syn.render_depth(scene, CFG.intrinsics, traj[i]), traj[i])
            for i in range(n)]


def test_mapper_state_roundtrip_and_jax_checkpoints(tmp_path):
    """A port checkpoint restores bit for bit and keeps integrating; a JAX
    checkpoint of a mapper state loads into the port (same leaf keys)
    ≡ utils.interop's carry of that state, and the reverse."""
    state = sm.create_mapper(CFG, CPU)
    for i, (d, c, T) in enumerate(_frames(4)):
        sm.mapper_step(CFG, state, d, c, T, i * 0.1)
    p = str(tmp_path / "mapper.npz")
    assert ckpt.save_pytree(p, state) > 0
    restored = ckpt.load_pytree(p, sm.create_mapper(CFG, CPU))
    a, b = (interop.mapper_state_to_numpy(s) for s in (state, restored))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    d, c, T = _frames(1)[0]
    sm.mapper_step(CFG, restored, d, c, T, 0.5)
    assert int(restored.frame_count) == 5

    import jax
    from coxgraph_tpu.mapper import submap_mapper as jsm

    jstate = jsm.create_mapper(tcc.CFG)
    assert jckpt.load_pytree(p, jstate) is not None   # port → JAX
    jp = str(tmp_path / "jax.npz")
    jckpt.save_pytree(jp, jax.tree.map(np.asarray, jckpt.load_pytree(
        p, jstate)))
    back = interop.mapper_state_to_numpy(
        ckpt.load_pytree(jp, sm.create_mapper(CFG, CPU)))   # JAX → port
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)


def test_load_pytree_shape_mismatch(tmp_path):
    p = str(tmp_path / "x.npz")
    ckpt.save_pytree(p, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.load_pytree(p, {"a": torch.zeros(4)})
    with pytest.raises(KeyError):
        ckpt.load_pytree(p, {"b": torch.zeros(3)})


def test_preemption_resume_bit_identical(tmp_path):
    """Checkpoint mid-clip, restore into a FRESH HostMapper, continue: the
    final state equals the uninterrupted run's exactly."""
    frames = _frames(6)
    ref = sm.HostMapper(CFG, device=CPU)
    for i, (d, c, T) in enumerate(frames):
        ref.step(d, c, T, i * 0.1)
    hm1 = sm.HostMapper(CFG, device=CPU)
    for i, (d, c, T) in enumerate(frames[:3]):
        hm1.step(d, c, T, i * 0.1)
    p = str(tmp_path / "preempt.npz")
    ckpt.save_pytree(p, hm1.state)
    del hm1
    hm2 = sm.HostMapper(CFG, ckpt.load_pytree(p, sm.create_mapper(CFG,
                                                                  CPU)))
    for i, (d, c, T) in enumerate(frames[3:], start=3):
        hm2.step(d, c, T, i * 0.1)
    a, b = (interop.mapper_state_to_numpy(h.state) for h in (ref, hm2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_server_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint_config.py's server: two clients of six
    frames, one fusion; the restored server keeps every pool row, pose and
    layer and keeps optimizing."""
    scene = syn.default_scene(CPU)
    trajs = [syn.orbit_trajectory(6, scene.room_center, radius=2.3,
                                  sweep=0.8 * float(np.pi), start_angle=s)
             for s in (0.0, 1.8)]
    clients = []
    for cid in range(2):
        st = sm.create_mapper(CFG, CPU)
        for i in range(6):
            d, c = syn.render_depth(scene, CFG.intrinsics, trajs[cid][i])
            sm.mapper_step(CFG, st, d, c, trajs[cid][i], i * 0.1)
        clients.append(InProcessClient(cid, CFG, st))
    cfg = fs.ServerConfig(spec=CFG.spec, max_submaps=16, refuse_interval=0.0,
                          height_prior_stddev=0.5,
                          registration=fs.reg.RegistrationConfig(
                              max_points=256, iterations=4))
    server = fs.CoxgraphServer(cfg, clients, CPU)
    assert server.map_fusion(fs.MapFusionMsg(
        0, 0.3, 1, 0.3, geo.relative(trajs[0][3], trajs[1][3]).numpy()))
    d = str(tmp_path / "server_ckpt")
    ckpt.save_server(d, server)
    server2 = fs.CoxgraphServer(cfg, clients, CPU)
    ckpt.load_server(d, server2)
    assert server2.cli_ser == server.cli_ser
    assert server2.constraint_kinds == server.constraint_kinds
    assert server2.fused == server.fused
    for pool in ("_cons", "_heights"):
        a, b = getattr(server, pool), getattr(server2, pool)
        assert a.count == b.count > 0
        for k in a.fields:
            np.testing.assert_array_equal(a.fields[k], b.fields[k])
    for s, s2 in zip(server.submaps, server2.submaps):
        np.testing.assert_array_equal(s.T_G_submap, s2.T_G_submap)
        np.testing.assert_array_equal(s.hist_poses, s2.hist_poses)
        a, b = (interop.layer_to_numpy(x.layer) for x in (s, s2))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    server2.optimize()
    assert all(np.isfinite(s.T_G_submap).all() for s in server2.submaps)
