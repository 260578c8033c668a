"""coxgraph_tpu_torch.utils.interop: state and configs carried across from
the JAX package exactly, and the port never importing jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import tsdf as jtsdf
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.utils import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JCFG = jsm.MapperConfig(
    spec=jvx.VoxelGridSpec(voxel_size=0.2, voxels_per_side=8, grid_dim=16,
                           max_blocks=64, truncation=0.6),
    integrator=jtsdf.TsdfIntegratorConfig(max_touched_blocks=32,
                                          use_pallas=False),
    intrinsics=jsyn.PinholeIntrinsics().scaled(0.05),       # 32x24
    max_submaps=4, max_history=8, submap_interval=0.2,
    height_prior_stddev=0.5)


def _jax_numpy(state):
    return {k: np.asarray(v) for k, v in interop.flatten(state).items()}


def _jax_state():
    """A JAX mapper state with submaps, constraints and voxels in it."""
    scene = jsyn.default_scene()
    traj = np.asarray(jsyn.orbit_trajectory(5, scene.room_center,
                                            radius=2.5, sweep=0.5))
    depths = np.stack([np.asarray(jsyn.render_depth(
        scene, JCFG.intrinsics, traj[i])[0]) for i in range(5)])
    hm = jsm.HostMapper(JCFG)
    hm.step_batch(depths, None, traj, np.arange(5) * 0.1)
    return hm.state


def test_mapper_state_round_trip_is_exact():
    want = _jax_numpy(_jax_state())
    assert int(want["collection.num_submaps"]) == 3
    assert int(want["constraints.count"]) == 2
    state = interop.mapper_state_from_numpy(want, CPU)
    assert isinstance(state, sm.MapperState)
    assert state.collection.layers.sdf.shape == want[
        "collection.layers.sdf"].shape
    got = interop.mapper_state_to_numpy(state)
    assert set(got) == set(want)
    for key, a in want.items():
        assert got[key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[key], a, err_msg=key)


def test_layer_round_trip_is_exact():
    jl = jsm.get_layer(_jax_state().collection.layers, 1)
    want = _jax_numpy(jl)
    got = interop.layer_to_numpy(interop.layer_from_numpy(want, CPU))
    for key, a in want.items():
        np.testing.assert_array_equal(got[key], a, err_msg=key)


def test_port_continues_a_jax_state():
    """A JAX state carried into the port keeps integrating: the port's
    HostMapper resumes at the carried submap count and clock."""
    state = interop.mapper_state_from_numpy(_jax_numpy(_jax_state()), CPU)
    hm = sm.HostMapper(interop.config_from(JCFG), state)
    assert hm.n_submaps == 3 and not hm.mirror_enabled
    assert hm.last_start == pytest.approx(0.4, abs=1e-6)
    depth = np.full((2, 24, 32), 2.0, np.float32)
    T = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (2, 1))
    assert hm.step_batch(depth, None, T, [0.5, 0.6]) == 1
    assert int(hm.state.collection.num_submaps) == 4
    assert int(hm.state.frame_count) == 7


# the JAX integrator's fields for the TPU's Pallas path and working set
TPU_ONLY = {"update_chunk_blocks", "use_pallas", "window_union_blocks",
            "tile_h"}


def test_config_from_copies_every_field():
    """Every field of the port's configs is the JAX config's, nested
    configs too; the JAX integrator's TPU-only fields are not ported."""
    cfg = interop.config_from(JCFG)
    assert isinstance(cfg, sm.MapperConfig)

    def same(a, b, path):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                same(x, y, path + f.name + ".")
            else:
                assert x == y, path + f.name

    same(cfg, JCFG, "")
    ported = {f.name for f in dataclasses.fields(cfg.integrator)}
    jax_fields = {f.name for f in dataclasses.fields(JCFG.integrator)}
    assert TPU_ONLY <= jax_fields and not TPU_ONLY & ported
    assert ported == jax_fields - TPU_ONLY
    # defaults agree too
    assert interop.config_from(jsm.MapperConfig()) == sm.MapperConfig()


def test_config_from_refuses_unported_fields():
    """Every config field of the JAX package is ported now: a
    MapperConfig's point integrator crosses exactly, and only a config
    class the port does not have is refused."""
    from coxgraph_tpu.ops import points as jpoints

    jp = jpoints.PointIntegratorConfig(band_samples=5, carve_samples=3,
                                       merge_points=False)
    cfg = interop.config_from(dataclasses.replace(JCFG,
                                                  point_integrator=jp))
    assert dataclasses.asdict(cfg.point_integrator) == \
        dataclasses.asdict(jp)

    @dataclasses.dataclass(frozen=True)
    class UnportedConfig:
        x: int = 0

    with pytest.raises(TypeError):
        interop.config_from(UnportedConfig())


def test_solve_state_and_configs_cross_exactly():
    """Constraint and height-prior pools on their own, a list of layers,
    a SolveResult and the solve's configs carry across unchanged."""
    from coxgraph_tpu.ops import registration as jreg
    from coxgraph_tpu_torch.ops import registration as reg
    from coxgraph_tpu_torch.solver import pose_graph as pg

    state = _jax_state()
    cons = interop.constraints_from_numpy(
        _jax_numpy(state.constraints), CPU)
    hts = interop.heights_from_numpy(_jax_numpy(state.heights), CPU)
    assert isinstance(cons, pg.RelPoseConstraints)
    assert isinstance(hts, pg.HeightConstraints)
    for pool, jpool in ((cons, state.constraints), (hts, state.heights)):
        got, want = interop.pool_to_numpy(pool), _jax_numpy(jpool)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(cons.count) == 2 and int(hts.count) == 3

    jlayers = [jsm._get_layer(state.collection.layers, k) for k in (0, 1)]
    layers = interop.layers_from_numpy([_jax_numpy(l) for l in jlayers], CPU)
    for layer, jl in zip(layers, jlayers):
        got, want = interop.layer_to_numpy(layer), _jax_numpy(jl)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jres = jpg.optimize(state.collection.T_odom_submap, state.constraints,
                        jpg.SolverConfig(iterations=2))
    res = interop.solve_result_from_numpy(
        interop.solve_result_to_numpy(jres), CPU)
    assert isinstance(res, pg.SolveResult)
    for k, v in interop.solve_result_to_numpy(res).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jres, k)))

    for jc in (jpg.SolverConfig(iterations=3, huber_delta=0.2,
                                yaw_only=True),
               jreg.RegistrationConfig(max_points=64,
                                       phase2_dispatch_iters=2)):
        c = interop.config_from(jc)
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert interop.config_from(jpg.SolverConfig()) == pg.SolverConfig()
    assert interop.config_from(jreg.RegistrationConfig()) == \
        reg.RegistrationConfig()
    cfg = interop.config_from(dataclasses.replace(
        JCFG, local_solver=jpg.SolverConfig(huber_delta=0.3)))
    assert cfg.local_solver == pg.SolverConfig(huber_delta=0.3)


def test_port_never_imports_jax():
    """With jax blocked, and PIL and yaml too (the card's machine has
    neither), every module of the port (and chip_smoke.py, bench_torch.py,
    the profiling tools and the torch examples) imports, and coxgraph_tpu
    is never reached."""
    code = r"""
import importlib, os, pkgutil, runpy, sys
for blocked in ("jax", "PIL", "yaml"):
    sys.modules[blocked] = None
import coxgraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    coxgraph_tpu_torch.__path__, "coxgraph_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
runpy.run_path("bench_torch.py", run_name="not_main")
for tool in ("profile_torch_integrate.py", "profile_torch_detect.py",
             "profile_torch_serve.py", "endurance_run_torch.py",
             "time_k1_variants.py", "time_k2_variants.py",
             "bench_torch_runs.py"):
    runpy.run_path(os.path.join("tools", tool), run_name="not_main")
for example in ("two_robot_demo_torch.py", "distributed_demo_torch.py",
                "experiment_driver_torch.py", "pointcloud_demo_torch.py",
                "multichip_dryrun_torch.py", "single_robot_demo_torch.py"):
    runpy.run_path(os.path.join("examples", example), run_name="not_main")
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "coxgraph_tpu" or m.startswith("coxgraph_tpu.")
    or m == "jax" or m.startswith("jax."))]
assert not bad, bad
print("imported", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 45
