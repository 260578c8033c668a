"""coxgraph_tpu_torch.comm.wire against coxgraph_tpu.comm.wire: the same
layer serializes to the same bytes, the JAX package's bytes decode to the
same rows, coords and slot order, and the packed messages are byte for
byte the JAX package's (tests/test_wire.py's layer: three 80×60 frames
into 10 cm voxels, 8³ blocks, 1,024 blocks)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.comm import wire as jwire
from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.core import voxel as jvx
import test_wire as tw
from coxgraph_tpu_torch.comm import wire
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
SPEC = interop.config_from(tw.SPEC)
_LAYER = {}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layers():
    """(JAX layer, the same layer in the port on the CPU)."""
    if not _LAYER:
        jl = tw.make_layer()
        _LAYER["j"] = jl
        _LAYER["p"] = interop.layer_from_numpy(
            {k: np.asarray(v) for k, v in interop.flatten(jl).items()}, CPU)
    return _LAYER["j"], _LAYER["p"]


def test_serialize_layer_is_byte_identical():
    jl, pl = layers()
    buf = wire.serialize_layer(SPEC, pl)
    assert buf == jwire.serialize_layer(tw.SPEC, jl)
    assert vx.memory_size_bytes(pl) / len(buf) > 5.0
    coords, sdf, w, c = wire.live_rows(pl)
    n = int(jl.num_blocks)
    np.testing.assert_array_equal(coords, np.asarray(jl.block_coords)[:n])
    np.testing.assert_array_equal(sdf, np.asarray(jl.sdf)[:n])
    np.testing.assert_array_equal(c, np.asarray(jl.color)[:n])


def test_deserialize_jax_bytes_is_bit_identical():
    """JAX's bytes → the port's layer ≡ JAX's decoded layer: rows, coords,
    block index and slot order."""
    jl, _ = layers()
    buf = jwire.serialize_layer(tw.SPEC, jl)
    got = interop.layer_to_numpy(wire.deserialize_layer(SPEC, buf, CPU))
    want = jwire.deserialize_layer(tw.SPEC, buf)
    for name, a in interop.flatten(want).items():
        np.testing.assert_array_equal(got[name], np.asarray(a),
                                      err_msg=name)


def test_deserialize_needs_a_device_or_the_card(monkeypatch):
    jl, _ = layers()
    buf = jwire.serialize_layer(tw.SPEC, jl)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wire.deserialize_layer(SPEC, buf)


@pytest.mark.parametrize("case", ["bad", "too_many_blocks", "other_vps"])
def test_bad_buffers_rejected(case):
    jl, _ = layers()
    buf = b"garbage-not-a-layer"
    spec = SPEC
    if case != "bad":
        buf = jwire.serialize_layer(tw.SPEC, jl)
        spec = dataclasses.replace(
            SPEC, **({"max_blocks": 8} if case == "too_many_blocks"
                     else {"voxels_per_side": 4}))
    with pytest.raises(ValueError):
        wire.deserialize_layer(spec, buf, CPU)


@pytest.mark.parametrize("cloud", [False, True])
def test_submap_msg_is_byte_identical(cloud):
    jl, pl = layers()
    T = jgeo.from_xyzyaw(jnp.array([1.0, 2.0, 0.5, 0.3]))
    hs = np.array([0.1, 0.2, 0.3])
    hp = np.tile(np.asarray(jgeo.identity())[None], (3, 1))
    kw = {}
    if cloud:
        kw = dict(mesh_points=np.random.RandomState(0).randn(17, 3)
                  .astype(np.float32),
                  mesh_colors=(np.random.RandomState(1).rand(17, 3) * 255)
                  .astype(np.uint8))
    want = jwire.pack_submap_msg(tw.SPEC, 2, 5, jl, T, 0.1, 0.3, hs, hp,
                                 **kw)
    got = wire.pack_submap_msg(SPEC, 2, 5, pl, np.asarray(T), 0.1, 0.3, hs,
                               torch.from_numpy(hp), **kw)
    assert got == want
    msg = wire.unpack_submap_msg(SPEC, want, CPU)
    jmsg = jwire.unpack_submap_msg(tw.SPEC, want)
    for key in ("client_id", "submap_id", "t0", "t1"):
        assert msg[key] == jmsg[key]
    for key in ("T_cli_submap", "hist_stamps", "hist_poses"):
        np.testing.assert_array_equal(msg[key], np.asarray(jmsg[key]))
    if cloud:
        np.testing.assert_array_equal(msg["mesh_points"], kw["mesh_points"])
        np.testing.assert_array_equal(msg["mesh_colors"], kw["mesh_colors"])
    else:
        assert msg["mesh_points"] is None and msg["mesh_colors"] is None
    got_l = interop.layer_to_numpy(msg["layer"])
    for name, a in interop.flatten(jmsg["layer"]).items():
        np.testing.assert_array_equal(got_l[name], np.asarray(a))


def test_small_messages_are_byte_identical():
    pose = np.array([1, 0, 0, 0, 0.5, -1.0, 2.0], np.float32)
    assert wire.pack_map_transform(12.25, 7, torch.from_numpy(pose)) == \
        jwire.pack_map_transform(12.25, 7, pose)
    stamp, sid, out = wire.unpack_map_transform(
        jwire.pack_map_transform(12.25, 7, pose))
    assert stamp == 12.25 and sid == 7
    np.testing.assert_array_equal(out, pose)
    frames = {("odom", "base"): pose, ("mission_g", "client1_odom"): pose[::-1]}
    buf = jwire.pack_tf_set(3.5, frames)
    assert wire.pack_tf_set(3.5, frames) == buf
    stamp, got = wire.unpack_tf_set(buf)
    assert stamp == 3.5 and set(got) == set(frames)
    for key, p in frames.items():
        np.testing.assert_array_equal(got[key], p)


def test_bandwidth_log():
    log = wire.BandwidthLog()
    log.record("submap_0_1", 12345, 0.0)
    log.record("submap_0_2", 55555, 1.0)
    assert log.total_bytes() == 67900
    assert "2 transfers" in log.summary()
    assert [e.n_bytes for e in log.events] == [12345, 55555]
