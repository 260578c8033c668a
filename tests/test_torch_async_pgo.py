"""Asynchronous PGO in the port's fusion server — the contract of
tests/test_async_pgo.py: a fusion returns while the solve is still in
flight and frames integrate DURING the solve (the robot updates its state
in place under the client's pause lock), the next fusion waits for the
previous solve, a solve failure is contained, nonblocking fusions
coalesce into one re-run, an isolated final mesh leaves the online graph
bit-identical while robots, fusions and timeline ticks run, and deferred
local PGO runs on the robot's thread (its solve ≡ the JAX package's to
1e-5 on the submap poses; observed 3.7e-9 m), and a checkpoint taken
during an in-flight solve holds the pre-solve poses."""

import random
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_async_pgo as ta
from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.server import fusion_server as fs
from coxgraph_tpu_torch.server.client_interface import InProcessClient
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import interop
from test_torch_mesh import one_thread  # noqa: F401
from test_torch_solver import pose_errors

CPU = torch.device("cpu")
CFG = interop.config_from(ta.CFG)
SPEC = CFG.spec


@pytest.fixture(scope="module")
def frame():
    """(depth, color, T) of test_async_pgo.make_robot's one frame."""
    scene = syn.default_scene(CPU)
    T = syn.orbit_trajectory(1, scene.room_center, radius=2.5)[0]
    depth, color = syn.render_depth(scene, CFG.intrinsics, T)
    return depth, color, T


def make_robot(frame, client_id=0):
    depth, color, T = frame
    state = sm.create_mapper(CFG, CPU)
    t0 = torch.zeros(())
    sm.start_submap(CFG, state, T, t0)
    sm.integrate(CFG, state, depth, color, T, t0)
    return InProcessClient(client_id, CFG, state)


def make_server(frame, **kw):
    kw.setdefault("solver", pg.SolverConfig(iterations=3))
    clients = [make_robot(frame, 0), make_robot(frame, 1)]
    return fs.CoxgraphServer(
        fs.ServerConfig(spec=SPEC, max_submaps=8, refuse_interval=0.0,
                        **kw), clients, CPU), clients


def mf():
    return fs.MapFusionMsg(0, 0.0, 1, 0.0, geo.identity_np())


def integrate_once(client, frame, t):
    depth, color, T = frame
    with client.lock:
        sm.integrate(CFG, client.state, depth, color, T,
                     torch.full((), t))


def test_fusion_returns_while_solve_runs_and_integration_overlaps(frame):
    server, clients = make_server(frame, async_pgo=True)
    started, release = ta.gate_optimize(server)
    t0 = time.monotonic()
    assert server.map_fusion(mf())
    assert time.monotonic() - t0 < 30.0
    assert started.wait(10)
    assert server._opt_thread is not None and server._opt_thread.is_alive()
    assert server.fusion_log == []
    c0 = clients[0]
    w_before = float(c0.state.collection.layers.weight.sum())
    for i in range(3):
        integrate_once(c0, frame, 0.1 * (i + 1))
    assert float(c0.state.collection.layers.weight.sum()) > w_before
    assert server._opt_thread.is_alive()
    release.set()
    server.wait_for_optimize()
    assert len(server.fusion_log) == 1
    assert server.optimize_errors == []


def test_next_fusion_waits_for_previous_solve(frame):
    server, _ = make_server(frame, async_pgo=True)
    started, release = ta.gate_optimize(server)
    assert server.map_fusion(mf())
    assert started.wait(10)
    done2 = threading.Event()

    def second_fusion():
        server.map_fusion(mf())
        done2.set()

    t = threading.Thread(target=second_fusion)
    t.start()
    assert not done2.wait(0.5)         # parked on wait-for-previous
    release.set()
    assert done2.wait(30)
    t.join(timeout=30)
    assert not t.is_alive()
    server.wait_for_optimize()
    assert len(server.fusion_log) == 2
    assert server.optimize_errors == []


def test_solve_failure_is_contained(frame):
    server, _ = make_server(frame, async_pgo=True)

    def boom():
        raise RuntimeError("synthetic solver blow-up")

    server.optimize = boom
    assert server.map_fusion(mf())
    server.wait_for_optimize()
    assert server.optimize_errors and "blow-up" in server.optimize_errors[0]
    assert server.state_query()["n_submaps"] == 2


def test_nonblocking_fusion_coalesces_solves(frame):
    server, _ = make_server(frame, async_pgo=True, nonblocking_pgo=True)
    started, release = ta.gate_optimize(server)
    assert server.map_fusion(mf())
    assert started.wait(10)
    assert server.map_fusion(mf())
    assert server.map_fusion(mf())
    assert server._opt_thread is not None and server._opt_thread.is_alive()
    assert server.coalesced_solves >= 1
    assert server.constraint_kinds.count("fusion") == 3
    release.set()
    server.wait_for_optimize()
    assert len(server.fusion_log) == 2      # the first + ONE coalesced re-run
    assert server.optimize_errors == []
    assert torch.isfinite(server._poses()).all()


def test_nonblocking_solve_keeps_its_snapshot(frame, monkeypatch):
    """A fusion landing while a nonblocking solve is in flight changes the
    server's pool, not the pool the solve was given."""
    from coxgraph_tpu_torch.server import global_opt

    server, _ = make_server(frame, async_pgo=True, nonblocking_pgo=True)
    seen, entered, release = [], threading.Event(), threading.Event()
    real = global_opt.optimize_two_phase

    def gated(poses, constraints, *a, **k):
        before = interop.pool_to_numpy(constraints)
        seen.append((constraints, before))
        entered.set()
        assert release.wait(30)
        return real(poses, constraints, *a, **k)

    monkeypatch.setattr(global_opt, "optimize_two_phase", gated)
    assert server.map_fusion(mf())
    assert entered.wait(30)
    assert server.map_fusion(mf())          # lands mid-solve
    assert int(server.constraints.count) == 2
    release.set()
    server.wait_for_optimize()
    assert server.optimize_errors == []
    pool, before = seen[0]
    assert int(before["count"]) == 1
    for k, v in interop.pool_to_numpy(pool).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_timeline_retry_respects_final_mesh_lock(frame):
    server, _ = make_server(frame, solver=pg.SolverConfig(iterations=2))
    server.fused[1] = True
    assert server.map_fusion(fs.MapFusionMsg(0, 0.0, 1, 999.0,
                                             geo.identity_np())) is False
    assert len(server.future_queue) == 1
    started, release = ta.gate_optimize(server)
    fm_done, tick_done = threading.Event(), threading.Event()

    def final_mesh():
        server.get_final_global_mesh(isolate=True)
        fm_done.set()

    def timeline_tick():
        server.time_line_update()
        tick_done.set()

    tA = threading.Thread(target=final_mesh)
    tA.start()
    assert started.wait(30)
    tB = threading.Thread(target=timeline_tick)
    tB.start()
    assert not tick_done.wait(0.5)     # the retry drain waits
    release.set()
    assert fm_done.wait(120)
    assert tick_done.wait(30)
    for t in (tA, tB):
        t.join(timeout=30)
        assert not t.is_alive()
    assert server.optimize_errors == []


def _melee(frame, server, clients, seconds, extra=()):
    """Two robot frame loops, a fusion pump, a timeline ticker and the
    ``extra`` loops, concurrently for ``seconds`` (longer until ≥ 2
    fusions were accepted) with a short switch interval → (errors,
    accepted count)."""
    stop = threading.Event()
    errors, accepted = [], []

    def guarded(name, body):
        def run():
            try:
                body(stop)
            except Exception as e:          # pragma: no cover
                errors.append(f"{name}: {e!r}")
        return threading.Thread(target=run)

    def frame_loop(i):
        def body(stop):
            k = 0
            while not stop.is_set():
                k += 1
                integrate_once(clients[i], frame, 0.05 * k)
        return body

    def pump(stop):
        rng = random.Random(0)
        while not stop.is_set():
            if server.map_fusion(mf()):
                accepted.append(1)
            time.sleep(rng.uniform(0.0, 0.05))

    def ticker(stop):
        while not stop.is_set():
            server.time_line_update()
            server.state_query()
            server.global_frames()
            time.sleep(0.01)

    threads = [guarded("frame0", frame_loop(0)),
               guarded("frame1", frame_loop(1)),
               guarded("pump", pump), guarded("ticker", ticker)]
    threads += [guarded(f"extra{k}", fn) for k, fn in enumerate(extra)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for t in threads:
            t.start()
        t0 = time.time()
        while (time.time() - t0 < seconds
               or (len(accepted) < 2 and time.time() - t0 < 60.0)):
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    server.wait_for_optimize()
    return errors, len(accepted)


def test_concurrent_stress_random_interleaving(frame):
    """Every accepted fusion lands exactly one fusion_log entry, no thread
    raises, and the graph still solves after the melee."""
    server, clients = make_server(frame, async_pgo=True,
                                  solver=pg.SolverConfig(iterations=2))
    errors, n = _melee(frame, server, clients, 3.0)
    assert errors == [], errors
    assert server.optimize_errors == [], server.optimize_errors
    assert len(server.fusion_log) == n >= 2
    res = server.evaluate_residuals()
    assert all(np.isfinite(v) for vs in res.values() for v in vs)


def test_stress_final_mesh_isolation_under_melee(frame):
    """Each isolated final mesh, taken while robots, fusions and timeline
    ticks hammer the server, leaves the online poses and kinds
    bit-identical."""
    server, clients = make_server(frame, async_pgo=True,
                                  solver=pg.SolverConfig(iterations=2))
    rounds = []

    def mesh_loop(stop):
        while not stop.is_set():
            with server._fusion_lock:
                with server._state_lock:
                    pre = [(s.sid, np.array(s.T_G_submap))
                           for s in server.submaps]
                    pre_kinds = list(server.constraint_kinds)
                if len(pre) < 2:
                    continue
                server.get_final_global_mesh(isolate=True)
                with server._state_lock:
                    post = {s.sid: np.array(s.T_G_submap)
                            for s in server.submaps}
                    post_kinds = list(server.constraint_kinds)
            assert len(post) == len(pre)
            for sid, T in pre:
                np.testing.assert_array_equal(post[sid], T)
            assert post_kinds == pre_kinds
            rounds.append(1)

    errors, _ = _melee(frame, server, clients, 2.0, extra=(mesh_loop,))
    assert errors == [], errors
    assert server.optimize_errors == [], server.optimize_errors
    assert rounds
    res = server.evaluate_residuals()
    assert all(np.isfinite(v) for vs in res.values() for v in vs)


def test_deferred_local_pgo_runs_on_robot_thread_and_matches_jax():
    """defer_local_pgo: a forwarded closure only adds the constraint; the
    robot's own loop runs the solve. Both packages from the same state."""
    jc, (depth, color, T) = ta.make_robot(0)
    with jc.lock:
        st = jsm.start_submap(ta.CFG, jc.state, T, jnp.asarray(1.0))
        jc.state = jsm.integrate(ta.CFG, st, depth, color, T,
                                 jnp.asarray(1.0))
    c = interop.client_from(jc, CPU)
    T_meas = jgeo.from_xyzyaw(jnp.array([0.08, 0.0, 0.0, 0.0]))
    si = 30.0 * np.eye(6, dtype=np.float32)
    for client, meas in ((jc, T_meas), (c, np.asarray(T_meas))):
        client.defer_local_pgo = True
        assert client.receive_loop_closure(0.0, 1.0, meas, sqrt_info=si)
        assert client.local_pgo_pending
    before = c.state.collection.T_odom_submap.numpy().copy()
    np.testing.assert_array_equal(
        np.asarray(jc.state.collection.T_odom_submap), before)
    assert c.run_pending_local_pgo() and jc.run_pending_local_pgo()
    assert not c.local_pgo_pending
    after = c.state.collection.T_odom_submap.numpy()
    assert not np.allclose(after, before, atol=1e-6)
    dt, dr = pose_errors(after, np.asarray(jc.state.collection.T_odom_submap))
    assert dt <= 1e-5 and dr <= 1e-5, (dt, dr)
    assert not c.run_pending_local_pgo()


def test_checkpoint_during_inflight_solve(frame, tmp_path):
    """save_server taken while a background solve is in flight captures a
    consistent snapshot (all pre-solve poses: the solve applies its result
    atomically under _state_lock afterwards) and does not deadlock
    against the solve thread."""
    from coxgraph_tpu_torch.utils import checkpoint as ckpt

    server, _ = make_server(frame, async_pgo=True)
    started, release = ta.gate_optimize(server)
    assert server.map_fusion(mf())
    assert started.wait(10)
    pre_poses = [s.T_G_submap.copy() for s in server.submaps]
    d = str(tmp_path / "ckpt")
    ckpt.save_server(d, server)                   # solve still in flight
    release.set()
    server.wait_for_optimize()
    assert server.optimize_errors == []

    server2, _ = make_server(frame)
    ckpt.load_server(d, server2)
    assert len(server2.submaps) == len(pre_poses)
    for s, pre in zip(server2.submaps, pre_poses):
        np.testing.assert_allclose(s.T_G_submap, pre, atol=1e-7)
