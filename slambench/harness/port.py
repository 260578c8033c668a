"""The port's public entry points as the drivers use them, built from a
configuration file. Only the drivers import this module; the reference
never does."""

from __future__ import annotations

import contextlib

import torch


def fence(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def tracing(on: bool = True):
    """The port's program tracing (``runtime.tracing``: its ``cox.`` spans
    and counters) switched ``on`` for the block, and off after it."""
    from coxgraph_tpu_torch import runtime

    runtime.tracing(on)
    try:
        yield
    finally:
        runtime.tracing(False)


def counters() -> dict:
    """The port's counters so far (``runtime.snapshot()["counters"]``);
    a driver differences two readings around its stretch."""
    from coxgraph_tpu_torch import runtime

    return runtime.snapshot()["counters"]


def mapper_config(cfg: dict):
    """``mapper.submap_mapper.MapperConfig`` of a configuration file."""
    from coxgraph_tpu_torch.core import voxel as vx
    from coxgraph_tpu_torch.frontends.synthetic import PinholeIntrinsics
    from coxgraph_tpu_torch.mapper import submap_mapper as sm
    from coxgraph_tpu_torch.ops import tsdf as tsdf_ops

    t, m, c = cfg["tsdf"], cfg["mapper"], cfg["camera"]
    spec = vx.VoxelGridSpec(voxel_size=t["voxel_size"],
                            voxels_per_side=t["voxels_per_side"],
                            grid_dim=t["grid_dim"],
                            max_blocks=t["max_blocks"],
                            truncation=t["truncation"])
    integ = tsdf_ops.TsdfIntegratorConfig(
        max_range=t["max_range"], min_range=t["min_range"],
        max_weight=t["max_weight"],
        max_touched_blocks=t["max_touched_blocks"],
        alloc_band_samples=t["alloc_band_samples"],
        alloc_stride=t["alloc_stride"], use_dropoff=t["use_dropoff"],
        use_distance_weight=t["use_distance_weight"])
    intr = PinholeIntrinsics(width=c["width"], height=c["height"],
                             fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"])
    return sm.MapperConfig(spec=spec, integrator=integ, intrinsics=intr,
                           max_submaps=m["max_submaps"],
                           max_history=m["max_history"],
                           submap_interval=m["submap_interval"],
                           max_constraints=m["max_constraints"],
                           odom_sqrt_info=m["odom_sqrt_info"])


def load_kernels(device) -> None:
    """Build (or find built) and load the port's CUDA library."""
    if device.type == "cuda":
        from coxgraph_tpu_torch import _build
        _build.load()


def layer_rows(layers, k: int):
    """Submap ``k``'s allocated rows of a stacked collection → (coords
    (n, 3), sdf, weight, colour), copies."""
    from coxgraph_tpu_torch.mapper import submap_mapper as sm

    layer = sm.get_layer(layers, k)
    n = int(layer.num_blocks)
    return (layer.block_coords[:n].to(torch.int64).clone(),
            layer.sdf[:n].clone(), layer.weight[:n].clone(),
            layer.color[:n].clone())


def server_config(cfg: dict, mcfg):
    """``server.fusion_server.ServerConfig`` of a configuration file."""
    from coxgraph_tpu_torch.ops import registration as reg
    from coxgraph_tpu_torch.server import fusion_server as fs
    from coxgraph_tpu_torch.solver import pose_graph as pg

    s, r, v = cfg["server"], cfg["registration"], cfg["solver"]
    return fs.ServerConfig(
        spec=mcfg.spec, max_clients=s["max_clients"],
        max_submaps=s["max_submaps"], max_constraints=s["max_constraints"],
        refuse_interval=s["refuse_interval"],
        odom_sqrt_info=s["odom_sqrt_info"],
        fusion_sqrt_info=s["fusion_sqrt_info"],
        registration=reg.RegistrationConfig(
            max_points=r["max_points"], min_weight=r["min_weight"],
            band=r["band"], huber_delta=r["huber_delta"],
            max_reg_blocks=r["max_reg_blocks"]),
        solver=pg.SolverConfig(iterations=v["iterations"],
                               damping_init=v["damping_init"],
                               damping_up=v["damping_up"],
                               damping_down=v["damping_down"]),
        registration_weight=s["registration_weight"],
        async_pgo=s["async_pgo"], nonblocking_pgo=s["nonblocking_pgo"],
        max_registration_pairs=s["max_registration_pairs"],
        height_prior_stddev=s["height_prior_stddev"])
