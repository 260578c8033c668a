"""coxgraph_tpu_torch.parallel.fleet vs coxgraph_tpu.parallel.fleet on
tests/test_fleet.py's four robots at 40×30: fleet_step, and
test_fleet_optimize_aligns_robots' fleet_optimize.

JAX runs each program once per module on conftest's 8-device CPU mesh.
The port runs the same inputs twice: at world size 1 in this process
(gloo, a FileStore in a temporary directory) and at world size 2 in two
spawned gloo ranks of two robots each (one torch thread each), both
through tests/torch_parallel_workers.fleet_suite.

Tolerances: fleet_step per robot as tests/test_torch_mapper.py's
_assert_state_matches (integers exact, poses 1e-6, pools to that file's
shares), each robot ≡ the port's mapper_step alone exactly, world 2 ≡
world 1 exactly; fleet_optimize within 1e-4 of JAX, world 2 ≡ world 1 bit
for bit, and test_fleet_optimize_aligns_robots' 5e-3 to the truth. The
same suite runs once more at height_prior_stddev = 0.1, held to JAX's
programs at that config with the same tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_fleet as tfl
from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.parallel import fleet as jfl
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.parallel import fleet as fl
from coxgraph_tpu_torch.parallel import multihost
from coxgraph_tpu_torch.utils import interop
from test_torch_mapper import _assert_state_matches
from test_torch_mesh import one_thread  # noqa: F401
from torch_parallel_workers import fleet_suite

CPU = torch.device("cpu")
R = tfl.R
CFG = interop.config_from(tfl.CFG)
STEPS = 3                       # frames: rollovers at t = 0 and t = 0.2
HEIGHT_JCFG = dataclasses.replace(tfl.CFG, height_prior_stddev=0.1)
SAT_STEPS = 9                   # a fifth rollover at t = 0.8: saturated


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in interop.flatten(tree).items()}


def aligning_problem():
    """test_fleet_optimize_aligns_robots' problem → (JAX fleet, inter
    pool, ground truth (R,S,7))."""
    S = tfl.CFG.max_submaps
    key = jax.random.PRNGKey(0)

    def mk_chain(r):
        base = jgeo.from_xyzyaw(jnp.array([float(r), 0.5 * r, 0.0,
                                           0.4 * r]))
        rel = jgeo.se3_exp(jnp.array([0.0, 0.0, 0.1, 0.5, 0.1, 0.0]))
        poses = [base]
        for _ in range(S - 1):
            poses.append(jgeo.compose(poses[-1], rel))
        return jnp.stack(poses)

    gt = jnp.stack([mk_chain(r) for r in range(R)])
    fleet = jfl.create_fleet(tfl.CFG, R)
    noise = jax.vmap(lambda k: jgeo.se3_exp(jnp.concatenate(
        [jax.random.normal(k, (3,)) * 0.03,
         jax.random.normal(jax.random.fold_in(k, 7), (3,)) * 0.1])))(
        jax.random.split(key, R * S)).reshape(R, S, 7)
    init = jax.vmap(jax.vmap(jgeo.compose))(gt, noise)
    init = init.at[0, 0].set(gt[0, 0])
    cons = fleet.constraints
    for r in range(R):
        c = jpg.RelPoseConstraints.empty(tfl.CFG.max_constraints)
        for s in range(S - 1):
            c = c.add(s, s + 1, jgeo.relative(gt[r, s], gt[r, s + 1]),
                      10.0 * jnp.eye(6))
        cons = jax.tree.map(lambda all_, one, rr=r: all_.at[rr].set(one),
                            cons, c)
    col = dataclasses.replace(fleet.collection, T_odom_submap=init,
                              num_submaps=jnp.full((R,), S, jnp.int32))
    fleet = dataclasses.replace(fleet, collection=col, constraints=cons)
    inter = jpg.RelPoseConstraints.empty(16)
    for r in range(R - 1):
        inter = inter.add(r * S, (r + 1) * S,
                          jgeo.relative(gt[r, 0], gt[r + 1, 0]),
                          10.0 * jnp.eye(6))
    return fleet, inter, np.asarray(gt)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX program of the module, run once, and the suite's inputs
    as numpy."""
    torch.set_num_threads(1)
    out, inp = {}, {"cfg": CFG}
    mesh = jfl.make_robot_mesh(R)
    _, trajs, frames = tfl.make_inputs(SAT_STEPS)
    inp["traj"] = np.asarray(trajs)
    inp["depths"] = np.stack([np.asarray(f[0]) for f in frames[:STEPS]])
    inp["colors"] = np.stack([np.asarray(f[1]) for f in frames[:STEPS]])
    fleet = jfl.shard_fleet(jfl.create_fleet(tfl.CFG, R), mesh)
    for i in range(SAT_STEPS):
        d, c = frames[i]
        fleet = jfl.fleet_step(tfl.CFG, mesh, fleet, d, c, trajs[:, i],
                               jnp.full((R,), i * 0.1))
        if i == STEPS - 1:
            out["fleet"] = [_np(jfl.robot_state(fleet, r))
                            for r in range(R)]
    out["saturated"] = [_np(jfl.robot_state(fleet, r)) for r in range(R)]
    out["sat_frames"] = (np.stack([np.asarray(f[0]) for f in frames]),
                         np.stack([np.asarray(f[1]) for f in frames]))

    jfleet, jinter, gt = aligning_problem()
    inp["opt_fleet"] = _np(jfleet)
    inp["opt_inter"] = _np(jinter)
    _, jposes = jfl.fleet_optimize(tfl.CFG, mesh,
                                      jfl.shard_fleet(jfleet, mesh), jinter,
                                      jpg.SolverConfig(iterations=20))
    out["opt_poses"], out["gt"] = np.asarray(jposes), gt

    return inp, out


@pytest.fixture(scope="module")
def heights_side(jax_side):
    """fleet_step and fleet_optimize at height_prior_stddev = 0.1: JAX's
    programs and the port's suite at world size 1, on jax_side's inputs →
    (JAX's robots after STEPS steps, JAX's optimized poses, the port's
    suite result)."""
    inp = dict(jax_side[0], cfg=interop.config_from(HEIGHT_JCFG))
    mesh = jfl.make_robot_mesh(R)
    fleet = jfl.shard_fleet(jfl.create_fleet(HEIGHT_JCFG, R), mesh)
    for i in range(STEPS):
        fleet = jfl.fleet_step(HEIGHT_JCFG, mesh, fleet,
                               jnp.asarray(inp["depths"][i]),
                               jnp.asarray(inp["colors"][i]),
                               jnp.asarray(inp["traj"][:, i]),
                               jnp.full((R,), i * 0.1))
    robots = [_np(jfl.robot_state(fleet, r)) for r in range(R)]
    jfleet, jinter, _ = aligning_problem()
    _, jposes = jfl.fleet_optimize(HEIGHT_JCFG, mesh,
                                      jfl.shard_fleet(jfleet, mesh), jinter,
                                      jpg.SolverConfig(iterations=20))
    with multihost.single_process(CPU):
        port = fleet_suite(inp)
    return robots, np.asarray(jposes), port


@pytest.fixture(scope="module")
def world1(jax_side):
    with multihost.single_process(CPU):
        return fleet_suite(jax_side[0])


@pytest.fixture(scope="module")
def world2(jax_side):
    return multihost.spawn(fleet_suite, 2, (jax_side[0],), device=CPU)


def _robot(fleet_np: dict, r: int) -> dict:
    return {k: v[r] for k, v in fleet_np.items()}


def _state(arrays: dict) -> sm.MapperState:
    return interop.mapper_state_from_numpy(arrays, CPU)


@pytest.mark.parametrize("r", range(R))
def test_fleet_step_matches_jax(jax_side, world1, r):
    _assert_state_matches(_state(jax_side[1]["fleet"][r]),
                          _state(_robot(world1["fleet"], r)))


@pytest.mark.parametrize("r", range(R))
def test_fleet_step_robot_equals_its_mapper_alone(jax_side, world1, r):
    """A robot of the fleet ≡ the same robot through mapper_step (the
    rollover decided on the host), exactly."""
    inp = jax_side[0]
    st = sm.create_mapper(CFG, CPU)
    for i in range(STEPS):
        sm.mapper_step(CFG, st, torch.from_numpy(inp["depths"][i, r]),
                       torch.from_numpy(inp["colors"][i, r]),
                       torch.from_numpy(inp["traj"][r, i]), i * 0.1)
    got = _robot(world1["fleet"], r)
    for k, v in interop.mapper_state_to_numpy(st).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_fleet_step_two_ranks_equal_one(world1, world2):
    """Each rank's robots ≡ the same robots at world size 1."""
    for rank, res in enumerate(world2):
        for k, v in res["fleet"].items():
            np.testing.assert_array_equal(
                v, world1["fleet"][k][2 * rank:2 * rank + 2], err_msg=k)


def test_fleet_saturation_drops_the_chain_constraint(jax_side):
    """Reference fault (ROADMAP queue 3): past max_submaps the JAX fleet's
    rollover (parallel/fleet.py _start_one) still chains a constraint to
    the slot it could not open, j = max_submaps — outside the pose vector
    — where the mapper's start_submap drops it. The port's fleet keeps the
    mapper's rule: at 9 frames (a fifth rollover into 4 slots) each robot
    holds 3 chain constraints, as mapper_step does, JAX's 4."""
    inp, out = jax_side
    S = CFG.max_submaps
    depths, colors = out["sat_frames"]
    with multihost.single_process(CPU):
        mesh = fl.make_robot_mesh(R, CPU)
        fleet = fl.shard_fleet(fl.create_fleet(CFG, R, CPU), mesh)
        for i in range(SAT_STEPS):
            fl.fleet_step(CFG, mesh, fleet, torch.from_numpy(depths[i]),
                          torch.from_numpy(colors[i]),
                          torch.from_numpy(inp["traj"][:, i]),
                          torch.full((R,), i * 0.1))
    for r in range(R):
        j = out["saturated"][r]
        assert int(j["collection.num_submaps"]) == S
        assert int(j["constraints.count"]) == S
        assert int(j["constraints.j"][S - 1]) == S      # outside the poses
        c = fleet.states[r].constraints
        assert int(c.count) == S - 1
        assert int(c.j.max()) == S - 1
        st = sm.create_mapper(CFG, CPU)
        for i in range(SAT_STEPS):
            sm.mapper_step(CFG, st, torch.from_numpy(depths[i, r]),
                           torch.from_numpy(colors[i, r]),
                           torch.from_numpy(inp["traj"][r, i]), i * 0.1)
        assert int(st.constraints.count) == S - 1


def test_fleet_optimize_matches_jax_and_aligns(jax_side, world1):
    out = jax_side[1]
    poses = world1["opt_poses"]
    np.testing.assert_allclose(poses, out["opt_poses"], atol=1e-4, rtol=0)
    got = world1["opt_fleet_T"]
    np.testing.assert_array_equal(poses.reshape(got.shape), got)
    err = geo.se3_log(geo.relative(torch.from_numpy(got),
                                   torch.from_numpy(out["gt"])))
    assert float(err.abs().max()) < 5e-3


def test_fleet_optimize_two_ranks_equal_one(world1, world2):
    """Bit for bit: each robot's normal equations and cost are summed
    apart, so the ranks' shares change no rounding."""
    for rank, res in enumerate(world2):
        np.testing.assert_array_equal(res["opt_poses"], world1["opt_poses"])
        np.testing.assert_array_equal(
            res["opt_fleet_T"], world1["opt_fleet_T"][2 * rank:2 * rank + 2])


def test_fleet_with_height_priors_matches_jax(jax_side, heights_side):
    """At height_prior_stddev = 0.1 the fleet's rollovers record no height
    prior, as the JAX fleet's (parallel/fleet.py _start_one) record none:
    each robot's state, its heights pool included (empty), equals JAX's
    field by field, and fleet_optimize's poses stay within 1e-4 of JAX's.
    The single-robot mapper at that config does record one a submap."""
    robots, jposes, port = heights_side
    inp = jax_side[0]
    cfg = interop.config_from(HEIGHT_JCFG)
    for r in range(R):
        got = _robot(port["fleet"], r)
        assert int(got["collection.num_submaps"]) == 2
        assert int(got["heights.count"]) == 0
        assert int(robots[r]["heights.count"]) == 0
        _assert_state_matches(_state(robots[r]), _state(got))
        st = sm.create_mapper(cfg, CPU)
        for i in range(STEPS):
            sm.mapper_step(cfg, st, torch.from_numpy(inp["depths"][i, r]),
                           torch.from_numpy(inp["colors"][i, r]),
                           torch.from_numpy(inp["traj"][r, i]), i * 0.1)
        assert int(st.heights.count) == 2
    np.testing.assert_allclose(port["opt_poses"], jposes, atol=1e-4, rtol=0)
