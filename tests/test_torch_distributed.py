"""eval.demos.distributed_demo and pointcloud_demo on the CPU at a small
point: two robot processes (spawned) mapping an 80×60 clip of 8 frames
into 10 cm voxels, serving their submaps over the native bus to the
fusion server in this process, then the mesh-with-history transport; and
eight shuffled 80×60 clouds through HostMapper.step_points. The card runs
both at the demos' own points (chip_smoke.py phase 13); here every gate
that does not count K1 launches (there are none on the CPU) must hold."""

import dataclasses

import pytest
import torch

from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.eval import demos

CPU = torch.device("cpu")
SPEC = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                        max_blocks=512, truncation=0.3)
FRAMES = 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_configs():
    """demo_configs at 80×60 with 512-block, 10 cm, 8³ pools, three
    submaps a robot."""
    cfg, scfg, det, _ = demos.demo_configs(FRAMES, 0.125, 30.0)
    cfg = dataclasses.replace(
        cfg, spec=SPEC, max_submaps=4,
        integrator=dataclasses.replace(cfg.integrator,
                                       max_touched_blocks=256),
        submap_interval=FRAMES * demos.DT / 3)
    scfg = dataclasses.replace(
        scfg, spec=SPEC, max_submaps=16,
        registration=dataclasses.replace(scfg.registration, max_points=256,
                                         iterations=4))
    return cfg, scfg, det, dataclasses.replace(SPEC, max_blocks=2048)


def test_distributed_demo_on_the_cpu(tmp_path):
    res = demos.distributed_demo(CPU, frames=FRAMES, scale=0.125,
                                 out=str(tmp_path), configs=small_configs(),
                                 timeout=240)
    assert res["ok"], res["gates"]
    assert "k1_per_frame" not in res["gates"]        # the card's gate
    assert res["server_submaps"] == 6
    assert [r["frames"] for r in res["robots"]] == [FRAMES] * 2
    assert len(res["recovered"]) == 6
    assert res["pulled_sdf_err"] <= SPEC.truncation / 32000 + 1e-7
    assert (tmp_path / "coxgraph_server_mesh.ply").exists()
    assert (tmp_path / "coxgraph_server_traj.txt").exists()
    assert 0 < res["wire_ratio"] < 0.5


def test_pointcloud_demo_on_the_cpu():
    cfg = dataclasses.replace(
        demos.pointcloud_configs(FRAMES, 0.125), spec=SPEC,
        integrator=dataclasses.replace(
            demos.pointcloud_configs(FRAMES, 0.125).integrator,
            max_touched_blocks=256))
    res = demos.pointcloud_demo(CPU, frames=FRAMES, scale=0.125, cfg=cfg)
    assert res["ok"], res
    assert res["submaps"] == 4 and res["points_per_cloud"] == 80 * 60


def test_demos_need_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (demos.distributed_demo, demos.pointcloud_demo):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
