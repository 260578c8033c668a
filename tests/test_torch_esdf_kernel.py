"""The ESDF kernels' wrapper (``ops.cuda_esdf``) on the CPU.

Its kernels (``csrc/esdf_sweep.cu``) run only on a card, where
tests/test_torch_cuda.py holds them to the plain sweeps bit for bit. Here:
the wrapper refuses a layer off the card before any launch, and its
operand check a layer the kernels cannot take; the steps it hands the
kernels, the plain version's, are in the kernels' (dx, dy, dz) order;
``runtime.snapshot()`` counts the launches; and the sweep count and steps
the plain version now reads from ``ops.esdf``'s helpers are the ones it
computed before."""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.ops import cuda_esdf
from coxgraph_tpu_torch.ops import esdf

SPEC = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=8,
                        max_blocks=16, truncation=0.2)
CLIENT_VGA = vx.VoxelGridSpec()     # 5 cm voxels, 16³ blocks, 8,192 slots


def _layer(spec=SPEC):
    r = torch.arange(-1, 1, dtype=torch.int32)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                         -1).reshape(-1, 3)
    return vx.allocate_blocks(spec, vx.create_tsdf_layer(spec, "cpu"),
                              coords)


@pytest.mark.parametrize("full", [False, True])
def test_kernel_steps_are_the_plain_steps_in_offset_order(full):
    """The sweep kernel walks the offsets of {-1,0,1}³ in lexicographic
    order (the faces alone when 6-connected) and reads the a-th step the
    wrapper hands it for the a-th: ``_neighbor_offsets(True)`` is in that
    order, and the 6 face steps are all one value, so the plain version's
    steps in its own order are the kernel's."""
    kernel = [o for o in itertools.product((-1, 0, 1), repeat=3)
              if any(o) and (full or sum(map(abs, o)) == 1)]
    offs = esdf._neighbor_offsets(full)
    steps = esdf.neighbor_steps(CLIENT_VGA, offs)
    assert steps.dtype == np.float32 and steps.shape == (len(kernel),)
    if full:
        assert [tuple(int(c) for c in o) for o in offs] == kernel
    else:
        assert sorted(tuple(int(c) for c in o) for o in offs) == kernel
        assert (steps == steps[0]).all()
    for s, o in zip(steps, offs):
        want = np.float32(np.sqrt(np.float32(sum(int(c) ** 2 for c in o)))) \
            * np.float32(CLIENT_VGA.voxel_size)
        assert s == want, o


def test_sweep_count_and_steps_match_the_old_arithmetic():
    """client_vga's 84 sweeps (4 m at 5 cm, 4 extra) and the steps as
    ops.esdf computed them inline before the helpers."""
    cfg = esdf.EsdfConfig(max_distance=4.0)
    assert esdf.sweep_count(CLIENT_VGA, cfg) == 84
    assert esdf.sweep_count(SPEC, esdf.EsdfConfig(max_distance=0.8)) == 12
    for full in (False, True):
        offs = esdf._neighbor_offsets(full)
        old = (np.sqrt((offs.astype(np.float32) ** 2).sum(
            axis=-1, dtype=np.float32))
            * np.float32(CLIENT_VGA.voxel_size)).astype(np.float32)
        assert np.array_equal(esdf.neighbor_steps(CLIENT_VGA, offs), old)
        assert math.isclose(float(old.min()), 0.05, rel_tol=1e-6)


def test_wrapper_refuses_a_layer_off_the_card():
    before = runtime.launches("esdf")
    with pytest.raises(ValueError, match="runs on cuda"):
        cuda_esdf.esdf_sweeps(SPEC, _layer(), esdf.EsdfConfig())
    assert runtime.launches("esdf") == before


@pytest.mark.parametrize("case", ["wide_blocks", "sdf_dtype", "weight_shape",
                                  "coords_shape", "index_dtype",
                                  "count_shape", "strided"])
def test_check_layer_rejects_what_the_kernels_cannot_take(case):
    """A block side over 16, and each wrong dtype, shape or layout, raise;
    the layer as allocated passes."""
    spec, layer = SPEC, _layer()
    cuda_esdf.check_layer(spec, layer, torch.device("cpu"))
    if case == "wide_blocks":
        spec = dataclasses.replace(SPEC, voxels_per_side=17)
    elif case == "sdf_dtype":
        layer.sdf = layer.sdf.double()
    elif case == "weight_shape":
        layer.weight = layer.weight[:-1]
    elif case == "coords_shape":
        layer.block_coords = layer.block_coords[:, :2].contiguous()
    elif case == "index_dtype":
        layer.block_index = layer.block_index.long()
    elif case == "count_shape":
        layer.num_blocks = layer.num_blocks.reshape(1)
    else:
        layer.sdf = layer.sdf.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        cuda_esdf.check_layer(spec, layer, torch.device("cpu"))


def test_snapshot_reports_esdf_launches(monkeypatch):
    """The wrapper's entry point counts under "esdf" in runtime, and
    launches added there (1 + n_iters a build) show in snapshot() as
    "esdf.launches"."""
    monkeypatch.setattr(runtime, "_launch_counts",
                        dict(runtime._launch_counts))
    assert cuda_esdf._BUILD.name == "esdf"
    before = runtime.snapshot()["counters"]["esdf.launches"]
    runtime.add_launches("esdf", 85)
    assert runtime.snapshot()["counters"]["esdf.launches"] == before + 85
    assert runtime.launches("esdf") == before + 85
