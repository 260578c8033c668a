"""What each rank of the parallel tier's tests runs (imports the port
only: ranks are spawned, and start from a fresh import). Every function
here runs over the default process group (world 1 in the test process,
or 2 spawned gloo ranks) on the CPU and returns numpy.

``fleet_suite`` drives fleet_step and fleet_optimize, ``maps_suite`` the
sharded ESDF, merge and mesh, on inputs the JAX package built;
``solve`` is the multi-process pose-graph solve; ``server_final_mesh``
the server's sharded final mesh."""

import numpy as np
import torch

from coxgraph_tpu_torch.ops import esdf as esdf_ops
from coxgraph_tpu_torch.ops import mesh as mesh_ops
from coxgraph_tpu_torch.parallel import esdf_sharded as es
from coxgraph_tpu_torch.parallel import fleet as fl
from coxgraph_tpu_torch.parallel import merge_sharded as msh
from coxgraph_tpu_torch.parallel import multihost
from coxgraph_tpu_torch.server import fusion_server as fs
from coxgraph_tpu_torch.server.client_interface import InProcessClient
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import interop
from coxgraph_tpu_torch.utils.tensorops import host

CPU = torch.device("cpu")
ESDF_CAPACITY = (256, 64)          # per-slab blocks, halo blocks


def _t(x):
    return torch.from_numpy(np.array(x))


def esdf_case(spec, layer_np, md, full, n_slabs, mesh):
    """The sharded ESDF of one layer → every slab's (D, Bd, v,v,v)."""
    layer = interop.layer_from_numpy(layer_np, CPU)
    cfg = es.ShardedEsdfConfig(*ESDF_CAPACITY, esdf_ops.EsdfConfig(
        max_distance=md, full_connectivity=full))
    parts = es.partition_blocks(spec, layer, n_slabs, cfg)
    dist = es.esdf_sharded(spec, mesh, parts, cfg)
    return host(es.gather_to_layer(spec, layer, parts, dist, mesh).dist)


def fleet_suite(inp: dict) -> dict:
    """One rank's fleet_step and fleet_optimize on ``inp`` (see
    test_torch_parallel.py) → its robots' results."""
    torch.set_num_threads(1)
    out = {}
    cfg = inp["cfg"]
    R = inp["depths"].shape[1]
    mesh = fl.make_robot_mesh(R, CPU)
    fleet = fl.shard_fleet(fl.create_fleet(cfg, R, CPU), mesh)
    for i in range(inp["depths"].shape[0]):
        fl.fleet_step(cfg, mesh, fleet, _t(inp["depths"][i]),
                      _t(inp["colors"][i]), _t(inp["traj"][:, i]),
                      torch.full((R,), i * 0.1))
    out["fleet"] = interop.fleet_to_numpy(fleet)

    fleet = interop.fleet_from_numpy(inp["opt_fleet"], CPU, mesh)
    inter = interop.constraints_from_numpy(inp["opt_inter"], CPU)
    fleet, poses = fl.fleet_optimize(cfg, mesh, fleet, inter,
                                     pg.SolverConfig(iterations=20))
    out["opt_poses"] = host(poses)
    out["opt_fleet_T"] = np.stack([host(st.collection.T_odom_submap)
                                   for st in fleet.states])
    return out


def maps_suite(inp: dict) -> dict:
    """One rank's share of the sharded ESDF, merge and mesh on ``inp``
    (see test_torch_parallel_maps.py) → the gathered results."""
    torch.set_num_threads(1)
    out = {}
    mesh = fl.make_robot_mesh(device=CPU)
    out["esdf"] = {(name, D): esdf_case(inp["esdf_spec"], layer, md, full,
                                        D, mesh)
                   for name, (layer, md, full) in inp["esdf"].items()
                   for D in inp["esdf_slabs"]}

    spec = inp["merge_spec"]
    layers = interop.layers_from_numpy(inp["merge_layers"], CPU)
    poses = [_t(p) for p in inp["merge_poses"]]
    fused = msh.merge_layers_sharded(spec, mesh, layers, poses,
                                     max_touched=spec.max_blocks)
    out["merged"] = interop.layer_to_numpy(fused)
    out["mesh"] = msh.extract_mesh_sharded(spec, mesh, fused,
                                           min_weight=0.05,
                                           max_tris_per_device=100_000)
    out["mesh_sequential"] = mesh_ops.extract_mesh(spec, fused,
                                                   min_weight=0.05,
                                                   quantize=False)
    dspec = inp["cross_spec"]
    out["cross"] = interop.layer_to_numpy(msh.merge_layers_sharded(
        dspec, mesh, layers[:2], poses[:2], src_spec=spec,
        max_touched=dspec.max_blocks))
    return out


def solve(fleet_np: dict, inter_np: dict, cfg, iterations: int) -> dict:
    """The distributed fleet_optimize over the default group, every rank
    given the whole problem (make_global_pytree keeps its robots,
    replicate the inter-robot pool) → this rank's poses and byte counts."""
    torch.set_num_threads(1)
    R = next(iter(fleet_np.values())).shape[0]
    mesh = multihost.global_robot_mesh(R, CPU)
    rows = multihost.make_global_pytree(fleet_np, mesh)
    fleet = fl.Fleet(states=[interop.mapper_state_from_numpy(
        {k: host(v[i]) for k, v in rows.items()}, CPU)
        for i in range(mesh.per_rank)], first=mesh.share(R).start,
        n_robots=R)
    inter = pg.RelPoseConstraints(**multihost.replicate(inter_np, mesh))
    scfg = pg.SolverConfig(iterations=iterations)
    comm = multihost.fleet_optimize_comm_bytes(cfg, mesh, fleet, inter, scfg)
    _, poses = fl.fleet_optimize(cfg, mesh, fleet, inter, scfg)
    return {"poses": host(poses), "comm": comm}


def server_final_mesh(cfg, scfg, states, frame) -> dict:
    """A server over clients holding ``states``, control off, every submap
    collected and moved by the global-frame change ``frame``, then the
    final mesh sharded over the default group → its triangles, and the
    unsharded final mesh's."""
    torch.set_num_threads(1)
    clients = [InProcessClient(cid, cfg, interop.mapper_state_from_numpy(
        st, CPU)) for cid, st in enumerate(states)]
    server = fs.CoxgraphServer(scfg, clients, CPU)
    server.control_trigger(False)
    server.collect_all_submaps()
    for s in server.submaps:
        s.T_G_submap = fs.geo.compose_np(frame, s.T_G_submap).astype(
            np.float32)
    mesh = fl.make_robot_mesh(device=CPU)
    _, v, c = server.get_final_global_mesh(device_mesh=mesh)
    merged, vs, cs = server.get_final_global_mesh()
    # one quantum of the unsharded mesh's uint16 vertex grid (the live
    # blocks' extent / 65535, ops.mesh.quantize_mesh_device)
    n = int(merged.num_blocks)
    bc = host(merged.block_coords)[:n]
    lsb = float(((bc.max(0) + 1 - bc.min(0))
                 * server.cfg.spec.block_size).max()) / 65535.0
    return {"sharded": (v, c), "unsharded": (vs, cs), "lsb": lsb}
