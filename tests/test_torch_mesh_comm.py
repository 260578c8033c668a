"""coxgraph_tpu_torch.comm.mesh_comm against coxgraph_tpu.comm.mesh_comm on
tests/test_mesh_comm.py's submap (six 80×60 frames, 10 cm voxels, 8³
blocks, 2,048 blocks), the port's layer carried over with utils.interop.

Tolerances: from the same triangle soup the message is byte for byte the
JAX package's (qverts, faces, frame_runs and the packed bytes); from the
layer, the port extracts its own soup, whose vertices sit within one
quantization step of JAX's (tests/test_torch_mesh.py), so faces, runs and
colours are exact and the vertices within 2e-4 m. Decoded clouds within
1e-6. ``render_points``: depth exact, colour equal wherever a pixel's
nearest point is unique (the port takes the lowest index among equal z;
the reference's scatter order picks another). ``recover_layer``: the same
block set, and sdf and weight within 5e-3 where both observed (the repo's
tolerance between kernel paths, tests/test_pallas_tsdf.py:97-105), but
for the few merged voxels a boundary sample moves
(``test_recover_layer_matches_jax`` states their bound).
The "merged" method is held to the reference with its bundle validity
corrected (tests/test_torch_points.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_mesh_comm as tmc
from test_torch_points import fixed_reference  # noqa: F401 (a fixture)
from coxgraph_tpu.comm import mesh_comm as jmc
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.ops import mesh as jmesh
from coxgraph_tpu_torch.comm import mesh_comm
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.ops import mesh as mesh_ops
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
SPEC = interop.config_from(tmc.SPEC)
INTR = interop.config_from(tmc.INTR)
CFG = interop.config_from(tmc.CFG)
_SUBMAP = {}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def submap():
    """(JAX layer, the port's copy, stamps, poses, JAX soup)."""
    if not _SUBMAP:
        _, jl, stamps, poses = tmc.build_submap(6)
        pl = interop.layer_from_numpy(
            {k: np.asarray(v) for k, v in interop.flatten(jl).items()}, CPU)
        _SUBMAP.update(j=jl, p=pl, stamps=stamps, poses=poses,
                       soup=jmesh.extract_mesh(tmc.SPEC, jl, min_weight=1e-4))
    s = _SUBMAP
    return s["j"], s["p"], s["stamps"], s["poses"], s["soup"]


def jax_msg(stride=2):
    """JAX's message of the submap (from its own soup, extracted once)."""
    key = ("msg", stride)
    if key not in _SUBMAP:
        jl, _, stamps, poses, soup = submap()
        _SUBMAP[key] = jmc.encode_submap_mesh(
            tmc.SPEC, jl, stamps, poses, tmc.INTR, client_id=1,
            submap_id=2, keyframe_stride=stride, soup=soup)
    return _SUBMAP[key]


def port_recovered(method):
    key = ("recovered", method)
    if key not in _SUBMAP:
        _SUBMAP[key] = mesh_comm.recover_layer(SPEC, CFG, INTR, jax_msg(2),
                                               method=method, device=CPU)
    return _SUBMAP[key]


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_encode_from_the_same_soup_is_byte_identical(stride):
    _, pl, stamps, poses, soup = submap()
    want = jax_msg(stride)
    got = mesh_comm.encode_submap_mesh(SPEC, pl, stamps, poses, INTR,
                                       client_id=1, submap_id=2,
                                       keyframe_stride=stride, soup=soup)
    assert got.pack() == want.pack()
    assert got.nbytes == want.nbytes == len(want.pack())
    for name in ("qverts", "faces", "frame_runs", "vcolors", "kf_stamps",
                 "kf_poses", "aabb_min"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.frame_idx, want.frame_idx)


def test_encode_from_the_layer_matches_jax():
    _, pl, stamps, poses, _ = submap()
    want = jax_msg(2)
    got = mesh_comm.encode_submap_mesh(SPEC, pl, stamps, poses, INTR,
                                       client_id=1, submap_id=2,
                                       keyframe_stride=2)
    assert got.faces.shape[0] > 100
    for name in ("faces", "frame_runs", "vcolors", "kf_poses"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.vertices(), want.vertices(), atol=2e-4,
                               rtol=0)
    # the bandwidth rationale of the transport: mesh ≪ voxel wire bytes
    from coxgraph_tpu_torch.comm import wire
    assert len(got.pack()) < 0.5 * len(wire.serialize_layer(SPEC, pl))


def test_unpack_of_jax_bytes():
    want = jax_msg(2)
    buf = want.pack()
    got = mesh_comm.MeshWithHistory.unpack(buf)
    back = jmc.MeshWithHistory.unpack(buf)
    assert (got.client_id, got.submap_id, got.t0, got.t1, got.scale) == \
        (back.client_id, back.submap_id, back.t0, back.t1, back.scale)
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, getattr(want, f.name))
    assert got.pack() == buf
    np.testing.assert_array_equal(got.vertices(), want.vertices())


@pytest.mark.parametrize("spacing", [0.05, 0.1])
def test_decode_matches_jax(spacing):
    msg = jax_msg(1)
    want = jmc.decode_to_pointclouds(msg, interpolate_voxel_size=spacing)
    got = mesh_comm.decode_to_pointclouds(msg,
                                          interpolate_voxel_size=spacing)
    assert set(got) == set(want) and len(got) >= 2
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[k][1], want[k][1], atol=1e-6, rtol=0)


def test_render_points_matches_jax():
    msg = jax_msg(2)
    clouds = jmc.decode_to_pointclouds(msg, interpolate_voxel_size=0.1)
    n_unique = 0
    for k, (p, c) in clouds.items():
        jd, jcol = (np.asarray(x) for x in jmc.render_points(tmc.INTR, p, c))
        depth, color = mesh_comm.render_points(INTR, torch.from_numpy(p),
                                               torch.from_numpy(c))
        np.testing.assert_array_equal(depth.numpy(), jd)
        # pixels whose nearest point is unique: the colour is that point's
        z = p[:, 2]
        zs = np.maximum(z, 1e-6)
        u = np.round(p[:, 0] / zs * INTR.fx + INTR.cx).astype(np.int64)
        v = np.round(p[:, 1] / zs * INTR.fy + INTR.cy).astype(np.int64)
        ok = (z > 0.05) & (u >= 0) & (u < INTR.width) & (v >= 0) \
            & (v < INTR.height)
        lin = (v * INTR.width + u)[ok]
        at_min = z[ok] == jd.reshape(-1)[lin]
        ties = np.bincount(lin[at_min], minlength=jd.size)
        unique = ties.reshape(jd.shape) == 1
        np.testing.assert_array_equal(color.numpy()[unique], jcol[unique])
        n_unique += int(unique.sum())
        assert (color.numpy()[jd == 0] == 0).all()
    assert n_unique > 1000


@pytest.mark.parametrize("method", ["projective", "merged"])
def test_recover_layer_matches_jax(method, fixed_reference):
    """The same block set; where both observed a voxel, sdf within 5e-3
    everywhere, and weight within 5e-3 everywhere for "projective". The
    merged weights sum whole bundles (up to 206 here): a band sample on a
    voxel boundary, placed in the neighbour by XLA's fused multiply-adds,
    moves one bundle's weight (tests/test_torch_points.py), so there at
    most 2e-4 of the voxels may pass 5e-3, and none 10 (measured: 4 of
    51,518 voxels, at most 4.0; sdf at most 4.0e-3, projective weight
    1.3e-5)."""
    want = jmc.recover_layer(tmc.SPEC, tmc.CFG, tmc.INTR, jax_msg(2),
                             method=method)
    g = interop.layer_to_numpy(port_recovered(method))
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(g[name],
                                      np.asarray(getattr(want, name)))
    jw, pw = np.asarray(want.weight), g["weight"]
    both = (jw > 0) & (pw > 0)
    iou = both.sum() / ((jw > 0) | (pw > 0)).sum()
    assert iou > 0.99, iou
    ds = np.abs(g["sdf"] - np.asarray(want.sdf))[both]
    assert ds.max() < 5e-3, ds.max()
    dw = np.abs(pw - jw)[both]
    if method == "projective":
        assert dw.max() < 5e-3, dw.max()
    else:
        assert (dw >= 5e-3).mean() <= 2e-4 and dw.max() < 10.0, (
            (dw >= 5e-3).sum(), dw.max())


@pytest.mark.parametrize("method", ["projective", "merged"])
def test_recover_layer_matches_surface(method):
    """tests/test_mesh_comm.py's gates on the port: the recovered TSDF's
    zero crossing lies on the scene surface."""
    rec = port_recovered(method)
    assert int(rec.num_blocks) > 10
    verts, _ = mesh_ops.extract_mesh(SPEC, rec, min_weight=1e-4)
    assert verts.shape[0] > 100
    sdf = syn.scene_sdf(syn.default_scene(CPU),
                        torch.from_numpy(verts.reshape(-1, 3))).numpy()
    assert np.quantile(np.abs(sdf), 0.9) < 2.0 * SPEC.voxel_size


def test_recover_empty_mesh_is_noop():
    layer = vx.create_tsdf_layer(SPEC, CPU)
    msg = mesh_comm.encode_submap_mesh(
        SPEC, layer, np.zeros(1),
        np.array([[1, 0, 0, 0, 0, 0, 0]], np.float32), INTR)
    want = jmc.encode_submap_mesh(
        tmc.SPEC, jmc.vx.create_tsdf_layer(tmc.SPEC), np.zeros(1),
        np.array([[1, 0, 0, 0, 0, 0, 0]], np.float32), tmc.INTR)
    assert msg.pack() == want.pack() and msg.faces.shape[0] == 0
    for method in ("merged", "projective"):
        out = mesh_comm.recover_layer(SPEC, CFG, INTR, msg, method=method,
                                      device=CPU)
        assert int(out.num_blocks) == 0
    with pytest.raises(ValueError):
        mesh_comm.recover_layer(SPEC, CFG, INTR, msg, method="fast",
                                device=CPU)


def test_frame_idx_is_chronological_first():
    runs = np.full((3, 2, 2), mesh_comm.RUN_SENTINEL, np.uint16)
    runs[0] = [[5, 9], [1, 1]]
    runs[1] = [[2, 3], [mesh_comm.RUN_SENTINEL, mesh_comm.RUN_SENTINEL]]
    args = (0, 0, 0.0, 1.0, np.zeros(3, np.float32), 1e-3,
            np.zeros((3, 3), np.uint16), np.zeros((3, 3), np.uint8),
            np.zeros((3, 3), np.uint32), runs, np.zeros(10),
            np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (10, 1)))
    got = mesh_comm.MeshWithHistory(*args)
    np.testing.assert_array_equal(got.frame_idx, [1, 2, 0])
    np.testing.assert_array_equal(got.frame_idx,
                                  jmc.MeshWithHistory(*args).frame_idx)


def test_visibility_runs_match_jax():
    rng = np.random.RandomState(3)
    ok = rng.rand(200, 9) > 0.4
    ok[:10] = False
    nidx = rng.randint(0, 9, 200).astype(np.uint16)
    for max_runs in (1, 2, 3):
        np.testing.assert_array_equal(
            mesh_comm._visibility_runs(ok, nidx, max_runs),
            jmc._visibility_runs(ok, nidx, max_runs))


def test_recover_needs_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_comm.recover_layer(SPEC, CFG, INTR, jax_msg(4))


def test_scene_surface_of_the_jax_world_is_the_ports():
    """The scene the gates use is the same analytic scene in both."""
    p = np.random.RandomState(0).uniform(-3, 3, (256, 3)).astype(np.float32)
    np.testing.assert_allclose(
        syn.scene_sdf(syn.default_scene(CPU), torch.from_numpy(p)).numpy(),
        np.asarray(jsyn.scene_sdf(jsyn.default_scene(), jnp.asarray(p))),
        atol=1e-6, rtol=0)
