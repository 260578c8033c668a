"""coxgraph_tpu_torch.parallel.esdf_sharded and merge_sharded vs
coxgraph_tpu.parallel on tests/test_esdf_sharded.py's spheres and
tests/test_merge_sharded.py's three submaps.

JAX runs each program once per module on conftest's 8-device CPU mesh.
The port runs the same inputs at world size 1 in this process (gloo, a
FileStore in a temporary directory) and at world size 2 in two spawned
gloo ranks (one torch thread each), both through
tests/torch_parallel_workers.maps_suite.

Tolerances: the sharded ESDF bit-identical to the port's esdf_from_tsdf
and to JAX's esdf_sharded (1, 2 and 4 slabs, 6- and 26-connectivity, the
boundary case); the sharded merge (its three submaps moved off the voxel
lattice by one change of the global frame) held to JAX's sharded merge
and to the port's sequential merge with test_merge_sharded.py's
tolerances (weights 1e-5, sdf 1e-4, colour 2e-2 on the voxels both
observe; observed 4.8e-6 against JAX, 3e-8 against the sequential merge),
cross resolution within 1e-5 of JAX; the sharded mesh's triangles ≡ the
sequential extractor's as a set. A reference fault: JAX's sharded merge at
a small max_touched leaves allocated blocks empty, the port's server path
(sized to the pool) does not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_esdf_sharded as tes
import test_merge_sharded as tms
from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.ops import esdf as jesdf
from coxgraph_tpu.parallel import esdf_sharded as jes
from coxgraph_tpu.parallel import merge_sharded as jms
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.ops import esdf as esdf_ops
from coxgraph_tpu_torch.ops import merge as merge_ops
from coxgraph_tpu_torch.parallel import esdf_sharded as es
from coxgraph_tpu_torch.parallel import fleet as fl
from coxgraph_tpu_torch.parallel import merge_sharded as msh
from coxgraph_tpu_torch.parallel import multihost
from coxgraph_tpu_torch.utils import interop
from test_torch_mesh import one_thread  # noqa: F401
from torch_parallel_workers import maps_suite

CPU = torch.device("cpu")
ESDF_CASES = {"sphere6": ([0.05, -0.1, 0.0], 0.35, 0.8, False),
              "sphere26": ([0.05, -0.1, 0.0], 0.35, 0.8, True),
              "boundary": ([-0.6, 0.0, 0.0], 0.3, 3.0, False)}
SLABS = (1, 2, 4)
# one generic change of the global frame for the merge's poses: as built,
# every camera is level, so one voxel axis of each submap lands on the
# destination lattice, where the trilinear base voxel follows rounding and
# jitted JAX and the port part on ~0.5% of the voxels (ROADMAP queue 3;
# test_torch_server.py's final-mesh test steps around it the same way)
FRAME = jnp.concatenate([jgeo.so3_exp(jnp.array([0.031, -0.017, 0.113])),
                         jnp.array([0.0123, -0.0371, 0.0217])])
DSPEC = jvx.VoxelGridSpec(voxel_size=0.2, voxels_per_side=8, grid_dim=16,
                          max_blocks=256, truncation=0.6)
# a max_touched below one submap's cover of the merged pool (each of the
# three covers a few hundred of its 827 blocks)
CAPPED_TOUCHED = 64


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in interop.flatten(tree).items()}


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX program of the module, run once, and the suite's inputs
    as numpy."""
    torch.set_num_threads(1)
    out, inp = {}, {}
    inp["esdf_spec"] = interop.config_from(tes.SPEC)
    inp["esdf_slabs"] = SLABS
    inp["esdf"] = {}
    emesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    for name, (c, rad, md, full) in ESDF_CASES.items():
        tsdf = tes.sphere_tsdf(c, rad)
        inp["esdf"][name] = (_np(tsdf), md, full)
        ecfg = jesdf.EsdfConfig(max_distance=md, full_connectivity=full)
        cfg = jes.ShardedEsdfConfig(per_device_blocks=128, halo_blocks=64,
                                    esdf=ecfg)
        parts = jes.partition_blocks(tes.SPEC, tsdf, 4, cfg)
        out[("parts", name)] = interop.sharded_blocks_to_numpy(parts)
        dist = jes.esdf_sharded(tes.SPEC, emesh, parts, cfg)
        out[("esdf", name)] = np.asarray(
            jes.gather_to_layer(tes.SPEC, tsdf, parts, dist).dist)

    _, layers, poses = tms.build_submaps(3)
    poses = [jgeo.compose(FRAME, p) for p in poses]
    inp["merge_spec"] = interop.config_from(tms.SPEC)
    inp["cross_spec"] = interop.config_from(DSPEC)
    inp["merge_layers"] = [_np(la) for la in layers]
    inp["merge_poses"] = [np.asarray(p) for p in poses]
    out["stacked"] = _np(jms.stack_layers(layers, tms.SPEC, pad_to=4))
    mmesh = Mesh(np.array(jax.devices()[:8]), ("dev",))
    out["merged"] = _np(jms.merge_layers_sharded(
        tms.SPEC, mmesh, layers, poses, max_touched=tms.SPEC.max_blocks))
    out["capped"] = _np(jms.merge_layers_sharded(
        tms.SPEC, mmesh, layers, poses, max_touched=CAPPED_TOUCHED))
    out["cross"] = _np(jms.merge_layers_sharded(
        DSPEC, mmesh, layers[:2], poses[:2], src_spec=tms.SPEC,
        max_touched=DSPEC.max_blocks))
    return inp, out


@pytest.fixture(scope="module")
def world1(jax_side):
    with multihost.single_process(CPU):
        return maps_suite(jax_side[0])


@pytest.fixture(scope="module")
def world2(jax_side):
    return multihost.spawn(maps_suite, 2, (jax_side[0],), device=CPU)


@pytest.mark.parametrize("case", list(ESDF_CASES))
@pytest.mark.parametrize("slabs", SLABS)
def test_sharded_esdf_bit_identical(jax_side, world1, world2, case, slabs):
    """≡ the port's single-device ESDF and JAX's 4-device sharded ESDF,
    at world size 1 and 2."""
    inp, out = jax_side
    spec = inp["esdf_spec"]
    layer_np, md, full = inp["esdf"][case]
    layer = interop.layer_from_numpy(layer_np, CPU)
    ref = esdf_ops.esdf_from_tsdf(spec, layer, esdf_ops.EsdfConfig(
        max_distance=md, full_connectivity=full)).dist.numpy()
    n = int(layer.num_blocks)
    for got in (world1["esdf"][(case, slabs)],
                *(w["esdf"][(case, slabs)] for w in world2)):
        np.testing.assert_array_equal(got[:n], ref[:n])
        np.testing.assert_array_equal(got[:n], out[("esdf", case)][:n])
    if case == "boundary":
        # the rightmost blocks really received propagated values
        bc = layer.block_coords[:n].numpy()
        right = bc[:, 0] == bc[:, 0].max()
        assert (np.abs(ref[:n][right]) < md - 1e-3).any()


def _observed_pairs(a: dict, b: dict):
    """Slots of the blocks both layers allocated (a's, b's)."""
    ia, ib = a["block_index"], b["block_index"]
    sel = (ia >= 0) & (ib >= 0)
    return ia[sel], ib[sel]


def _assert_merge_gates(a: dict, b: dict) -> None:
    """test_merge_sharded.py's gates between two fused layers."""
    sa, sb = _observed_pairs(a, b)
    wa, wb = a["weight"][sa], b["weight"][sb]
    np.testing.assert_allclose(wa, wb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(wa.sum(), a["weight"].sum(), rtol=1e-6)
    np.testing.assert_allclose(wb.sum(), b["weight"].sum(), rtol=1e-6)
    live = wb > 1e-6
    np.testing.assert_allclose(a["sdf"][sa][live], b["sdf"][sb][live],
                               atol=1e-4, rtol=0)
    live3 = np.tile(live, (1, 3))
    np.testing.assert_allclose(a["color"][sa][live3], b["color"][sb][live3],
                               atol=2e-2, rtol=0)


def test_sharded_merge_matches_jax_and_sequential(jax_side, world1, world2):
    inp, out = jax_side
    spec = inp["merge_spec"]
    got = world1["merged"]
    assert int(got["num_blocks"]) > 10
    _assert_merge_gates(got, out["merged"])
    seq = merge_ops.merge_layer_into(
        spec, vx.create_tsdf_layer(spec, CPU),
        interop.layer_from_numpy(inp["merge_layers"][0], CPU),
        torch.from_numpy(inp["merge_poses"][0]), spec.max_blocks)
    for la, T in zip(inp["merge_layers"][1:], inp["merge_poses"][1:]):
        merge_ops.merge_layer_into(spec, seq,
                                   interop.layer_from_numpy(la, CPU),
                                   torch.from_numpy(T), spec.max_blocks)
    _assert_merge_gates(got, interop.layer_to_numpy(seq))
    for res in world2:
        _assert_merge_gates(res["merged"], got)


def test_sharded_merge_cross_resolution_matches_jax(jax_side, world1,
                                                    world2):
    out = jax_side[1]
    for got in (world1["cross"], *(w["cross"] for w in world2)):
        for name in ("block_index", "block_coords", "num_blocks"):
            np.testing.assert_array_equal(got[name], out["cross"][name])
        assert int(got["num_blocks"]) > 5
        for name in ("sdf", "weight", "color"):
            np.testing.assert_allclose(got[name], out["cross"][name],
                                       atol=1e-5, rtol=0, err_msg=name)


def _triangle_keys(v: np.ndarray) -> set:
    return {tuple(k) for k in np.round(v.mean(1) * 1e4).astype(np.int64)}


def test_sharded_mesh_equals_sequential(world1, world2):
    for res in (world1, *world2):
        v, c = res["mesh"]
        vs, cs = res["mesh_sequential"]
        assert v.shape == vs.shape and v.shape[0] > 100
        assert _triangle_keys(v) == _triangle_keys(vs)
        order = np.lexsort(v.reshape(len(v), -1).T)
        order_s = np.lexsort(vs.reshape(len(vs), -1).T)
        np.testing.assert_array_equal(v[order], vs[order_s])
        np.testing.assert_array_equal(c[order], cs[order_s])


def test_partition_matches_jax_and_carries_across(jax_side):
    """partition_blocks ≡ JAX's field for field (4 slabs); JAX's partition
    carried in through utils.interop sweeps to the single-device ESDF."""
    inp, out = jax_side
    spec = inp["esdf_spec"]
    with multihost.single_process(CPU):
        mesh = fl.make_robot_mesh(device=CPU)
        for name, (layer_np, md, full) in inp["esdf"].items():
            layer = interop.layer_from_numpy(layer_np, CPU)
            cfg = es.ShardedEsdfConfig(128, 64, esdf_ops.EsdfConfig(
                max_distance=md, full_connectivity=full))
            got = interop.sharded_blocks_to_numpy(
                es.partition_blocks(spec, layer, 4, cfg))
            want = out[("parts", name)]
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            parts = interop.sharded_blocks_from(want, CPU)
            dist = es.gather_to_layer(spec, layer, parts, es.esdf_sharded(
                spec, mesh, parts, cfg), mesh).dist
            ref = esdf_ops.esdf_from_tsdf(spec, layer, cfg.esdf).dist
            n = int(layer.num_blocks)
            assert torch.equal(dist[:n], ref[:n])


def test_stacked_layers_carry_across_and_merge(jax_side, world1):
    """JAX's stack_layers (three submaps padded to four) ≡ the port's,
    carried in by utils.interop.layers_from_stacked, and
    merge_submaps_sharded over the stacked layer ≡ merge_layers_sharded."""
    inp, out = jax_side
    spec = inp["merge_spec"]
    layers = interop.layers_from_numpy(inp["merge_layers"], CPU)
    stacked = msh.stack_layers(layers, spec, pad_to=4)
    got = {k: v.numpy() for k, v in interop.flatten(stacked).items()}
    for k, v in out["stacked"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = interop.layers_from_stacked(stacked, CPU)
    assert int(back[3].num_blocks) == 0
    for a, b in zip(back, layers):
        for k, v in interop.layer_to_numpy(b).items():
            np.testing.assert_array_equal(interop.layer_to_numpy(a)[k], v)
    poses = torch.stack([torch.from_numpy(p) for p in inp["merge_poses"]]
                        + [geo.identity(CPU)])
    with multihost.single_process(CPU):
        fused = msh.merge_submaps_sharded(spec, fl.make_robot_mesh(device=CPU),
                                          stacked, poses,
                                          max_touched=spec.max_blocks)
    for k, v in interop.layer_to_numpy(fused).items():
        np.testing.assert_array_equal(v, world1["merged"][k], err_msg=k)


def test_traffic_accounting_matches_jax():
    """ici_bytes_per_update and ici_bytes_per_optimize: the JAX package's
    static formulas, ported as they are."""
    from coxgraph_tpu.mapper import submap_mapper as jsm
    from coxgraph_tpu.parallel import fleet as jfl
    from coxgraph_tpu.solver import pose_graph as jpg
    from coxgraph_tpu_torch.solver import pose_graph as pg

    for E in (8, 64):
        jcfg = jes.ShardedEsdfConfig(per_device_blocks=64, halo_blocks=E)
        cfg = es.ShardedEsdfConfig(per_device_blocks=64, halo_blocks=E)
        assert es.ici_bytes_per_update(interop.config_from(tes.SPEC), cfg) \
            == jes.ici_bytes_per_update(tes.SPEC, jcfg)
    for R in (2, 8):
        jm = jsm.MapperConfig(spec=tes.SPEC, max_submaps=4)
        assert fl.ici_bytes_per_optimize(
            interop.config_from(jm), R, pg.SolverConfig(iterations=3)) == \
            jfl.ici_bytes_per_optimize(jm, R, jpg.SolverConfig(iterations=3))


def _empty_blocks(layer: dict) -> int:
    """Allocated blocks that no voxel of any submap reached."""
    n = int(layer["num_blocks"])
    return int((layer["weight"][:n].max(axis=1) <= 0).sum())


def test_reference_sharded_merge_drops_blocks_past_max_touched(jax_side,
                                                               world1):
    """Reference fault (ROADMAP queue 3): merge_layers_sharded
    (parallel/merge_sharded.py:162-176) accumulates each submap into only
    its first max_touched touched destination slots (ops/tsdf.py:189-200,
    "picked up on later calls"), and a single-pass merge has no later
    call, so a submap whose cover passes max_touched leaves blocks
    allocated and empty — the reference's final mesh at its default 4,096
    on a wider pool; here at 64. The port's server path sizes the merge to
    the pool (CoxgraphServer._merge_and_mesh, max_touched=max_blocks) and
    keeps every block the sequential merge keeps; the port's sharded merge
    at the same small max_touched loses what JAX's loses."""
    import types

    from coxgraph_tpu_torch.server import fusion_server as fs

    inp, out = jax_side
    spec = inp["merge_spec"]
    full = world1["merged"]
    capped = out["capped"]
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(capped[name], out["merged"][name])
    lost = _empty_blocks(capped) - _empty_blocks(out["merged"])
    assert lost > 100, lost
    assert capped["weight"].sum() < 0.9 * out["merged"]["weight"].sum()

    layers = interop.layers_from_numpy(inp["merge_layers"], CPU)
    poses = [torch.from_numpy(p) for p in inp["merge_poses"]]
    server = types.SimpleNamespace(
        cfg=types.SimpleNamespace(spec=spec), device=CPU,
        submaps=[types.SimpleNamespace(sid=k, layer=la)
                 for k, la in enumerate(layers)],
        _poses=lambda: poses)
    with multihost.single_process(CPU):
        mesh = fl.make_robot_mesh(device=CPU)
        served, verts, _ = fs.CoxgraphServer._merge_and_mesh(
            server, spec, 0.05, mesh)
        port_capped = interop.layer_to_numpy(msh.merge_layers_sharded(
            spec, mesh, layers, poses, max_touched=CAPPED_TOUCHED))
    served = interop.layer_to_numpy(served)
    assert _empty_blocks(served) == _empty_blocks(full) \
        == _empty_blocks(out["merged"])
    _assert_merge_gates(served, full)
    assert verts.shape[0] > 100
    assert _empty_blocks(port_capped) == _empty_blocks(capped)
    _assert_merge_gates(port_capped, capped)
