"""Multi-view consistency fusion to a point cloud (port of
``tsar_mvs_tpu.models.fusion``, the exact ``fuse`` semantics).

For each reference pixel its 3-D point is projected into every other
view's depth map; a view is consistent when the relative depth
difference, the normal angle and the round-trip reprojection error are
all within thresholds. Pixels with enough consistent views emit the
averaged point, normal and gray value. With ``used_list`` the source
pixels a reference consumed are masked for the later references, so the
reference loop runs in order.

The votes of one reference are dense (H, W) maps on the device; only the
emitted points leave it. The view-sharded vote superset of the JAX
package is ``parallel/mesh.py::fuse_sharded``, which calls
``fusion_votes`` with an empty ``used`` mask.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tsar_mvs_tpu_torch.config import FusionParams
from tsar_mvs_tpu_torch import geometry as geo


@dataclass
class FusedCloud:
    points: np.ndarray    # (N, 3) world frame
    normals: np.ndarray   # (N, 3)
    colors: np.ndarray    # (N,) uint8 gray
    view_of: np.ndarray   # (N,) int32 originating reference view


def _nearest_lookup(img: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-pixel lookup of img (H, W) or (H, W, C) at (qx, qy).
    Returns (values, in-bounds mask, flat index). The mask is taken from
    the rounded float coordinates before any integer cast: a NaN cast to
    an integer is 0 on CUDA and would land in bounds at pixel (0, 0).
    Rounding is half to even, as jnp.round."""
    H, W = img.shape[:2]
    rx, ry = torch.round(qx), torch.round(qy)
    inb = (torch.isfinite(rx) & torch.isfinite(ry) & (rx >= 0)
           & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1))
    xi = torch.where(inb, rx, 0.0).to(torch.int64)
    yi = torch.where(inb, ry, 0.0).to(torch.int64)
    flat = yi * W + xi
    vals = img.reshape(H * W, *img.shape[2:])[flat]
    return vals, inb, flat


def fusion_votes(ref: int, depths: torch.Tensor, normals: torch.Tensor,
                 cams: geo.CameraSet, used: torch.Tensor,
                 fp: FusionParams):
    """Consistency votes for one reference view.

    depths: (V, H, W) metric depths in each view's own frame (0 invalid);
    normals: (V, H, W, 3) world-frame unit normals; cams: a *non-rebased*
    CameraSet (world-frame P); used: (V, H, W) bool consumed mask.

    Returns (point_sum (H, W, 3), normal_sum (H, W, 3), count (H, W),
    emit (H, W), consumed (V, H, W) pixels to mark used).

    One function serves both JAX variants: ``fusion_votes`` (static ref)
    and ``fusion_votes_traced`` / ``_fusion_votes_traced_jit`` (traced ref)
    exist there only to avoid recompiling per reference view.
    """
    V, H, W = depths.shape
    xx, yy = geo.pixel_grid(H, W, depths.device)
    d_ref = depths[ref]
    valid_ref = (d_ref > 0) & ~used[ref]
    X = geo.backproject(cams, ref, xx, yy, d_ref)        # (H, W, 3) world
    n_ref = normals[ref]

    cos_thr = math.cos(math.radians(fp.normal_thresh_deg))
    point_sum = X
    normal_sum = n_ref
    count = torch.zeros((H, W), dtype=torch.int32, device=depths.device)
    votes = {}
    for j in range(V):
        if j == ref:
            continue
        q, w_proj = geo.project(cams, j, X)
        d_j, inb, flat = _nearest_lookup(depths[j], q[..., 0], q[..., 1])
        n_j = normals[j].reshape(H * W, 3)[flat]
        used_j = used[j].reshape(-1)[flat]
        ok_depth = (d_j > 0) & (torch.abs(w_proj - d_j)
                                < fp.depth_diff * d_j)
        ok_angle = torch.sum(n_ref * n_j, dim=-1) > cos_thr
        # Round trip: the source pixel's own 3-D point must land within
        # reproj_error px of the reference pixel.
        X_j = geo.backproject(cams, j, torch.round(q[..., 0]),
                              torch.round(q[..., 1]), d_j)
        p_back, _ = geo.project(cams, ref, X_j)
        ok_reproj = ((p_back[..., 0] - xx) ** 2
                     + (p_back[..., 1] - yy) ** 2
                     < fp.reproj_error * fp.reproj_error)
        ok = inb & ok_depth & ok_angle & ok_reproj & valid_ref & ~used_j
        point_sum = point_sum + torch.where(ok[..., None], X_j, 0.0)
        normal_sum = normal_sum + torch.where(ok[..., None], n_j, 0.0)
        count = count + ok.to(torch.int32)
        votes[j] = (ok, flat)

    emit = valid_ref & (count >= fp.num_consistent)
    consumed = torch.zeros((V, H * W), dtype=torch.bool,
                           device=depths.device)
    consumed[ref] = emit.reshape(-1)
    for j, (ok, flat) in votes.items():
        mark = (ok & emit).reshape(-1)
        consumed[j, flat.reshape(-1)[mark]] = True
    return point_sum, normal_sum, count, emit, consumed.reshape(V, H, W)


def fuse(depths: np.ndarray, normals: np.ndarray, cams: geo.CameraSet,
         gray: np.ndarray, fp: FusionParams) -> FusedCloud:
    """Fused point cloud over all reference views, in order, on the
    device of `cams` (a non-rebased CameraSet). With fp.used_list each
    reference's consumed pixels are masked for the references after it,
    so the loop stays sequential. Normals are averaged and renormalised
    on the host in float32, as the JAX package does."""
    dev = cams.device
    V, H, W = depths.shape
    depths_t = torch.as_tensor(np.asarray(depths, np.float32), device=dev)
    normals_t = torch.as_tensor(np.asarray(normals, np.float32), device=dev)
    used = torch.zeros((V, H, W), dtype=torch.bool, device=dev)
    gray = np.asarray(gray)

    pts, nrms, cols, view_of = [], [], [], []
    for ref in range(V):
        ps, ns, count, emit, consumed = fusion_votes(
            ref, depths_t, normals_t, cams, used, fp)
        idx = torch.nonzero(emit.reshape(-1)).reshape(-1)
        denom = (count.reshape(-1)[idx] + 1).to(torch.float32)[:, None]
        p_avg = (ps.reshape(-1, 3)[idx] / denom).cpu().numpy()
        n_avg = (ns.reshape(-1, 3)[idx] / denom).cpu().numpy()
        n_avg /= np.maximum(np.linalg.norm(n_avg, axis=-1, keepdims=True),
                            1e-12)
        idx_np = idx.cpu().numpy()
        pts.append(p_avg)
        nrms.append(n_avg)
        cols.append(gray[ref].reshape(-1)[idx_np].astype(np.uint8))
        view_of.append(np.full(idx_np.shape[0], ref, np.int32))
        if fp.used_list:
            used |= consumed

    return FusedCloud(points=np.concatenate(pts),
                      normals=np.concatenate(nrms),
                      colors=np.concatenate(cols),
                      view_of=np.concatenate(view_of))
