"""The comparisons that decide ``correct``.

Submap layers are compared block by block, matched by block coordinate:
  * ``blocks_mismatch``: blocks allocated on one side only, as a share of
    the blocks allocated on either;
  * ``voxels_mismatch``: voxels observed (weight > 0) on either side whose
    SDF differs by more than ``SDF_TOL``, whose weight differs by more
    than ``W_REL_TOL`` of the reference's, or whose colour differs by more
    than ``RGB_TOL`` in a channel, as a share of the voxels observed on
    either side. A voxel of a block that only one side holds counts.
The tolerances sit far above float32 rounding (1e-7 relative) and far
below what any lower precision gives: a voxel within them agrees.
"""

from __future__ import annotations

import torch

from . import geometry as geo

SDF_TOL = 1e-3      # m (a fiftieth of a 5 cm voxel)
W_REL_TOL = 1e-3
RGB_TOL = 1e-3      # a quarter of one 8-bit step


def _keys(coords: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def layers(test, ref, tie=None) -> dict:
    """test, ref: (coords (n, 3), sdf (n, v³), weight (n, v³), colour
    (n, 3·v³)) → {"blocks_mismatch", "voxels_mismatch", "blocks",
    "voxels", "voxels_bad", "voxels_bad_at_ties"}. ``tie`` (the
    reference's (n, v³) rounding-tie flags) only splits the count of
    mismatched voxels; it changes no compared number."""
    dev = ref[1].device
    test = tuple(x.to(dev) for x in test)
    kt, kr = _keys(test[0]), _keys(ref[0])
    union = torch.unique(torch.cat([kt, kr]))
    n = union.numel()
    it = torch.searchsorted(union, kt)
    ir = torch.searchsorted(union, kr)
    v3 = ref[1].shape[1]
    f32 = torch.float32

    def dense(side, idx):
        sdf = torch.zeros((n, v3), dtype=f32, device=dev)
        w = torch.zeros((n, v3), dtype=f32, device=dev)
        c = torch.zeros((n, 3, v3), dtype=f32, device=dev)
        has = torch.zeros((n,), dtype=torch.bool, device=dev)
        sdf[idx] = side[1].to(f32)
        w[idx] = side[2].to(f32)
        c[idx] = side[3].to(f32).reshape(-1, 3, v3)
        has[idx] = True
        return sdf, w, c, has

    st, wt, ct, ht = dense(test, it)
    sr, wr, cr, hr = dense(ref, ir)
    observed = (wt > 0) | (wr > 0)
    bad = ((torch.abs(st - sr) > SDF_TOL)
           | (torch.abs(wt - wr) > W_REL_TOL * torch.abs(wr))
           | (torch.abs(ct - cr) > RGB_TOL).any(dim=1)
           | (ht != hr)[:, None])
    n_obs = int(observed.sum())
    bad = bad & observed
    at_ties = 0
    if tie is not None:
        t = torch.zeros((n, v3), dtype=torch.bool, device=dev)
        t[ir] = tie
        at_ties = int((bad & t).sum())
    return {"blocks_mismatch": float((ht != hr).sum()) / max(n, 1),
            "voxels_mismatch": float(bad.sum()) / max(n_obs, 1),
            "blocks": n, "voxels": n_obs, "voxels_bad": int(bad.sum()),
            "voxels_bad_at_ties": at_ties}


def poses(test, ref) -> dict:
    """Pose sets (n, 7) → the largest translation gap (m) and rotation gap
    (rad) between matching poses."""
    t = test.to(torch.float64)
    r = ref.to(torch.float64)
    dt = torch.linalg.norm(t[:, 4:7] - r[:, 4:7], dim=-1)
    dq = geo.so3_log(geo.quat_mul(geo.quat_conj(r[:, :4]), t[:, :4]))
    return {"trans": float(dt.max()),
            "rot": float(torch.linalg.norm(dq, dim=-1).max())}
