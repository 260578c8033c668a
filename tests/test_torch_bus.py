"""coxgraph_tpu_torch.comm.bus: the cases of tests/test_bus.py on the port
(latched pub/sub, request/reply, the remote client transport, the server
over the bus, the server's own bus surface, mapping control, FAILED-state
recovery), and the two packages on one broker: a JAX robot behind a JAX
ClientService answers the port's RemoteClient, and a port robot answers
the JAX package's RemoteClient, with handles equal to those of an all-JAX
pair. Robots are tests/test_bus.py's, carried into the port with
``utils.interop``; everything of the port runs on the CPU."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import test_bus as tb
from coxgraph_tpu.comm import bus as jbus
from coxgraph_tpu_torch.comm import bus as cbus
from coxgraph_tpu_torch.comm import mesh_comm, wire
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.server import fusion_server as fs
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
SPEC = interop.config_from(tb.SPEC)
CFG = interop.config_from(tb.CFG)
# one wire step of sdf, and the f32 rounding of the dequantized value
STEP = SPEC.truncation / 32000 + 2 * float(np.spacing(np.float32(
    SPEC.truncation)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def broker():
    port = tb.free_port()
    b = cbus.Broker(port)
    yield port
    b.close()


def make_robot(client_id=0):
    """tests/test_bus.py's robot (one frame into one submap), in the
    port on the CPU."""
    return interop.client_from(tb.make_robot(client_id), CPU)


class Pumps:
    """Background threads that step services until ``stop()``."""

    def __init__(self, *svcs, timeout_ms=20):
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run,
                                          args=(s, timeout_ms))
                         for s in svcs]
        for t in self._threads:
            t.start()

    def _run(self, svc, timeout_ms):
        while not self._stop.is_set():
            svc.step(timeout_ms=timeout_ms)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join()


def proxy(port, cid, timeout_ms=60_000):
    return cbus.RemoteClient(port, client_id=cid, spec=SPEC,
                             timeout_ms=timeout_ms, device=CPU)


def server_over(proxies, **kw):
    kw.setdefault("solver", pg.SolverConfig(iterations=3))
    return fs.CoxgraphServer(fs.ServerConfig(spec=SPEC, max_submaps=8,
                                             **kw), proxies, CPU)


def wait_until(pred, seconds=10.0):
    deadline = time.time() + seconds
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


def test_pub_sub_and_latching(broker):
    pub, sub = cbus.BusClient(broker), cbus.BusClient(broker)
    sub.subscribe("tl")
    time.sleep(0.05)
    pub.publish("tl", b"hello")
    assert sub.poll(2000) == ("pub", "tl", b"hello")
    late = cbus.BusClient(broker)       # latched: the last message at once
    late.subscribe("tl")
    assert late.poll(2000) == ("pub", "tl", b"hello")
    for c in (pub, sub, late):
        c.close()


def test_request_reply_roundtrip(broker):
    server = cbus.BusClient(broker)
    server.advertise("echo")

    def serve():
        for _ in range(2):
            msg = server.poll(5000)
            assert msg and msg[0] == "req"
            server.reply(msg[3], msg[2][::-1])

    t = threading.Thread(target=serve)
    t.start()
    cli = cbus.BusClient(broker)
    assert cli.request("echo", b"abcdef", 5000) == b"fedcba"
    assert cli.request("echo", b"xy", 5000) == b"yx"
    t.join()
    assert cli.request("nope", b"z", 5000) == b""   # unknown: empty reply
    cli.close()
    server.close()


def test_remote_client_transport(broker):
    robot = make_robot(client_id=1)
    svc = cbus.ClientService(broker, robot, SPEC)
    pumps = Pumps(svc, timeout_ms=50)
    try:
        p = proxy(broker, 1)
        svc.publish_timeline()
        time.sleep(0.1)
        assert p.timeline() == robot.timeline()
        h = p.get_submap_by_time(0.0)
        local = robot.get_submap_by_time(0.0)
        assert h is not None and h.client_id == 1
        n = int(local.layer.num_blocks)
        assert int(h.layer.num_blocks) == n
        obs = local.layer.weight[:n] > 0
        # the wire quantizes sdf: within one step, truncation / 32000
        # (and the f32 rounding of the dequantized value)
        err = (h.layer.sdf[:n] - local.layer.sdf[:n]).abs()[obs].max()
        assert float(err) <= STEP
        np.testing.assert_array_equal(h.hist_poses, local.hist_poses)
        assert p.get_submap_by_time(1e6) is None
        assert p.req_state == cbus.ReqState.FUTURE
        assert len(p.get_all_submaps()) == 1
        np.testing.assert_allclose(p.lookup_pose_in_submap(0, 0.0),
                                   robot.lookup_pose_in_submap(0, 0.0),
                                   atol=1e-6)
        assert p.bandwidth.total_bytes() > 0
        new_pose = geo.from_xyzyaw(torch.tensor([1.0, 2.0, 0.0, 0.3]))
        p.apply_pose_updates([(0, new_pose)])
        time.sleep(0.1)
        np.testing.assert_allclose(robot.state.collection.T_odom_submap[0],
                                   new_pose, atol=1e-6)
    finally:
        pumps.stop()


def test_server_over_bus(broker):
    """CoxgraphServer drives remote robots through the bus: the fusion,
    the submap pulls and the pose push-back all ride RPC."""
    robots = [make_robot(0), make_robot(1)]
    pumps = Pumps(*[cbus.ClientService(broker, r, SPEC) for r in robots])
    try:
        server = server_over([proxy(broker, i) for i in range(2)])
        assert server.map_fusion(fs.MapFusionMsg(0, 0.0, 1, 0.0,
                                                 geo.identity_np()))
        assert len(server.submaps) == 2 and len(server.fusion_log) == 1
    finally:
        pumps.stop()


def test_server_service_and_remote_vio(broker, tmp_path):
    """The server's own bus surface: a RemoteVIO publishes a fusion and
    calls need_to_fuse / state_query / control_trigger / the final mesh /
    the pose history; a client pushes map_pose_updates and a submap mesh
    into the server's MeshCollection."""
    robots = [make_robot(0), make_robot(1)]
    svcs = [cbus.ClientService(broker, r, SPEC) for r in robots]
    server = server_over([proxy(broker, i) for i in range(2)],
                         refuse_interval=0.0)
    ss = cbus.ServerService(broker, server)
    # the server pump is its own thread: a fusion blocks on client RPCs
    pumps = Pumps(*svcs, ss, timeout_ms=10)
    try:
        vio = cbus.RemoteVIO(broker, timeout_ms=240_000)
        assert vio.need_to_fuse(0, 1, 0.0, use_cache=False)
        vio.publish_loop_closure(0, 0.0, 1, 0.0, geo.identity_np())
        assert wait_until(lambda: len(server.submaps) == 2, 20)
        q = vio.state_query()
        assert q["n_submaps"] == 2 and len(q["aabbs"]) == 2
        vio.control_trigger(False)
        assert wait_until(lambda: not server.in_control, 2)
        vio.control_trigger(True)
        ply = str(tmp_path / "m.ply")
        assert vio.get_final_global_mesh(ply) > 50
        assert os.path.exists(ply)
        stamps, poses = vio.get_pose_history(0)
        assert stamps.shape[0] > 0 and poses.shape[1] == 7
        traj = vio.save_pose_history(str(tmp_path))
        assert os.path.exists(traj)

        new_pose = geo.from_xyzyaw(torch.tensor([0.5, 0.0, 0.0, 0.1])
                                   ).numpy()
        robots[0].apply_pose_updates([(0, new_pose)])
        robots[0]._published_poses.pop(0)   # count it as a new pose
        svcs[0].publish_pose_updates()
        sid = server.cli_ser[(0, 0)]
        assert wait_until(lambda: np.allclose(
            server.submaps[sid].T_cli_submap, new_pose, atol=1e-6))

        h = robots[1].get_submap_by_time(0.0)
        msg = mesh_comm.encode_submap_mesh(
            SPEC, h.layer, h.hist_stamps, h.hist_poses, CFG.intrinsics,
            client_id=1, submap_id=0)
        svcs[1].publish_submap_mesh(msg)
        assert wait_until(lambda: (1, 0) in server.mesh_collection)
        assert server.mesh_collection[(1, 0)].pack() == msg.pack()
    finally:
        pumps.stop()


def test_mapping_control_and_pose_tf_over_bus(broker):
    """toggle_mapping / finish_map over the broker and the MapTransform
    submap-pose broadcast (client_handler.cpp:60)."""
    robot = make_robot(client_id=2)
    mapper = sm.HostMapper(CFG, robot.state)
    robot.mapper = mapper
    pumps = Pumps(cbus.ClientService(broker, robot, SPEC), timeout_ms=50)
    try:
        vio = cbus.RemoteVIO(broker)
        vio.toggle_mapping(2, False)
        assert not robot.mapping_enabled and not mapper.mapping_enabled
        vio.toggle_mapping(2, True)
        assert robot.mapping_enabled and mapper.mapping_enabled
        assert vio.finish_map(2) is True
        assert robot.finished and not mapper.mapping_enabled
        assert vio.finish_map(2) is False      # idempotent

        sub = cbus.BusClient(broker)
        sub.subscribe("client2/submap_pose_tf")
        new_pose = np.array([1, 0, 0, 0, 0.25, 0.5, -0.75], np.float32)
        proxy(broker, 2).apply_pose_updates([(0, torch.from_numpy(new_pose))])
        msg = sub.poll(5000)
        assert msg is not None and msg[0] == "pub"
        stamp, sid, pose = wire.unpack_map_transform(msg[2])
        assert sid == 0 and stamp > 0
        np.testing.assert_allclose(pose, new_pose, atol=1e-6)
        np.testing.assert_allclose(robot.state.collection.T_odom_submap[0],
                                   new_pose, atol=1e-6)
        sub.close()
    finally:
        pumps.stop()


def test_client_pose_history_over_bus(broker):
    robot = make_robot(client_id=3)
    pumps = Pumps(cbus.ClientService(broker, robot, SPEC), timeout_ms=50)
    try:
        stamps, poses = proxy(broker, 3).get_pose_history()
        ls, lp = robot.get_pose_history()
        np.testing.assert_allclose(stamps, ls)
        np.testing.assert_allclose(poses, lp, atol=1e-6)
        assert poses.shape[1] == 7
    finally:
        pumps.stop()


def test_server_survives_dead_client_mid_fusion(broker):
    """ReqState FAILED (client_handler.h:106, coxgraph_server.cpp:
    287-295): a robot whose services are advertised but not pumped makes
    the RPC time out; the server survives, queues the fusion, and lands
    it once the robot's pump returns."""
    robots = [make_robot(0), make_robot(1)]
    svcs = [cbus.ClientService(broker, r, SPEC) for r in robots]
    pump0 = Pumps(svcs[0])
    try:
        proxies = [proxy(broker, cid, timeout_ms=1500) for cid in range(2)]
        server = server_over(proxies, refuse_interval=0.0)
        mf = fs.MapFusionMsg(0, 0.0, 1, 0.0, geo.identity_np())
        assert server.map_fusion(mf) is False
        assert proxies[1].req_state == cbus.ReqState.FAILED
        assert proxies[1].failures >= 1
        assert len(server.future_queue) == 1
        pump1 = Pumps(svcs[1])
        try:
            server.time_line_update()
            assert len(server.future_queue) == 0
            assert len(server.submaps) == 2
            assert proxies[1].req_state == cbus.ReqState.SUCCESS
            assert len(server.fusion_log) == 1
        finally:
            pump1.stop()
    finally:
        pump0.stop()


def test_server_survives_unreachable_client(broker):
    """A fusion whose clients serve nothing yet is queued, not a crash;
    it lands once the robots appear."""
    proxies = [proxy(broker, cid, timeout_ms=2000) for cid in range(2)]
    server = fs.CoxgraphServer(
        fs.ServerConfig(spec=SPEC, max_submaps=16, refuse_interval=0.0),
        proxies, CPU)
    mf = fs.MapFusionMsg(0, 0.0, 1, 0.0, geo.identity_np())
    assert server.map_fusion(mf) is False
    assert len(server.future_queue) == 1
    robots = [make_robot(cid) for cid in range(2)]
    pumps = Pumps(*[cbus.ClientService(broker, r, SPEC) for r in robots],
                  timeout_ms=10)
    try:
        server.time_line_update()
        assert len(server.future_queue) == 0
        assert len(server.submaps) >= 2
    finally:
        pumps.stop()


def test_remote_vio_need_to_fuse_cache_ttl(broker):
    """need_to_fuse answers age out after ntf_cache_ttl of data time."""
    server = fs.CoxgraphServer(
        fs.ServerConfig(spec=SPEC, max_submaps=8, refuse_interval=5.0),
        [make_robot(0), make_robot(1)], CPU)
    pumps = Pumps(cbus.ServerService(broker, server), timeout_ms=5)
    try:
        vio = cbus.RemoteVIO(broker, timeout_ms=30_000, ntf_cache_ttl=5.0)
        server.last_fusion_time[(0, 1)] = 0.2
        assert vio.need_to_fuse(0, 1, 0.3) is False   # refused, cached
        assert vio.need_to_fuse(0, 1, 2.0) is False   # inside the TTL
        assert vio.need_to_fuse(0, 1, 5.4) is True    # aged out
    finally:
        pumps.stop()


def test_remote_client_needs_a_device_or_the_card(broker, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cbus.RemoteClient(broker, client_id=0, spec=SPEC)


# ---------------------------------------------------------------------------
# The two packages on one broker
# ---------------------------------------------------------------------------


def _same_handle(got, want):
    """A port handle ≡ a JAX one: ids, times, poses, history, layer."""
    assert (got.client_id, got.client_submap_id) == \
        (want.client_id, want.client_submap_id)
    assert (got.start_time, got.end_time) == (want.start_time,
                                              want.end_time)
    for name in ("T_cli_submap", "hist_stamps", "hist_poses"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    layer = got.layer
    if isinstance(layer.sdf, torch.Tensor):
        layer = interop.layer_to_numpy(layer)
    else:
        layer = {k: np.asarray(v)
                 for k, v in interop.flatten(layer).items()}
    for name, a in interop.flatten(want.layer).items():
        np.testing.assert_array_equal(layer[name], np.asarray(a),
                                      err_msg=name)


@pytest.mark.parametrize("robot_side", ["jax", "port"])
def test_packages_serve_each_other(broker, robot_side):
    """A robot of one package behind its ClientService answers the other
    package's RemoteClient with the handles an all-JAX pair exchanges;
    its services (lookup, pose push, pose history) answer too."""
    jrobot = tb.make_robot(client_id=1)
    if robot_side == "jax":
        svc = jbus.ClientService(broker, jrobot, tb.SPEC)
        other = proxy(broker, 1)
    else:
        svc = cbus.ClientService(broker, interop.client_from(jrobot, CPU),
                                 SPEC)
        other = jbus.RemoteClient(broker, client_id=1, spec=tb.SPEC)
    ref_robot = tb.make_robot(client_id=1)
    ref_port = tb.free_port()
    ref_broker = jbus.Broker(ref_port)
    ref_svc = jbus.ClientService(ref_port, ref_robot, tb.SPEC)
    ref = jbus.RemoteClient(ref_port, client_id=1, spec=tb.SPEC)
    pumps = Pumps(svc, ref_svc)
    try:
        _same_handle(other.get_submap_by_time(0.0),
                     ref.get_submap_by_time(0.0))
        (h,), (r,) = other.get_all_submaps(), ref.get_all_submaps()
        _same_handle(h, r)
        assert other.get_submap_by_time(1e6) is None
        np.testing.assert_array_equal(
            np.asarray(other.lookup_pose_in_submap(0, 0.0)),
            np.asarray(ref.lookup_pose_in_submap(0, 0.0)))
        for (a, b) in zip(other.get_pose_history(), ref.get_pose_history()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        pose = np.array([1, 0, 0, 0, 0.25, 0.5, -0.75], np.float32)
        other.apply_pose_updates([(0, pose)])
        robot = svc.client
        assert wait_until(lambda: np.allclose(
            np.asarray(interop.flatten(robot.state)[
                "collection.T_odom_submap"])[0], pose, atol=1e-6))
        other.toggle_mapping(False)
        assert not robot.mapping_enabled
    finally:
        pumps.stop()
        ref_broker.close()


def test_port_server_fuses_jax_robots(broker):
    """A JAX robot and a port server exchange submaps over one broker: the
    port's server fuses two JAX robots' submaps and pushes its poses back
    into their JAX states."""
    jrobots = [tb.make_robot(0), tb.make_robot(1)]
    pumps = Pumps(*[jbus.ClientService(broker, r, tb.SPEC)
                    for r in jrobots])
    try:
        server = server_over([proxy(broker, i) for i in range(2)])
        assert server.map_fusion(fs.MapFusionMsg(0, 0.0, 1, 0.0,
                                                 geo.identity_np()))
        assert len(server.submaps) == 2 and len(server.fusion_log) == 1
        for s in server.submaps:
            h = jrobots[s.client_id].get_submap_by_time(0.0)
            n = int(h.layer.num_blocks)
            assert int(s.layer.num_blocks) == n
            obs = np.asarray(h.layer.weight)[:n] > 0
            err = np.abs(s.layer.sdf[:n].numpy()
                         - np.asarray(h.layer.sdf)[:n])[obs]
            assert err.max() <= STEP
    finally:
        pumps.stop()
