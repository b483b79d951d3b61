"""TSAR refinement of a per-view plane field (port of
``tsar_mvs_tpu.models.tsar``).

1. confidence + left-right check (reverse cost at each pixel's best view)
2. coarse-to-fine WMF outlier marking
3. region RANSAC plane fit: every trueweak region of the view in one
   call (kernel B5 on the card), then one batched polish
4. border-consistency veto of implausible region planes
5. textureless fill
6. fine WMF hole filling
7. finalize: world-frame normals and metric depth
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models.weak_texture import WeakTexture
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.models import ransac
from tsar_mvs_tpu_torch.models.patchmatch import PlaneState, depth_map
from tsar_mvs_tpu_torch.ops import ncc, wmf


# Views whose RANSAC stage found no trueweak region of 3 reliable points,
# so kernel B5 did not launch for them (read by chip_smoke.py).
VIEWS_WITHOUT_REGIONS = 0


@dataclass
class TsarResult:
    depth: np.ndarray          # (H, W) metric depth (TSAR_disp.dmb payload)
    normal_world: np.ndarray   # (H, W, 3) world-frame normals
    normal_cam: np.ndarray     # (H, W, 3) rebased-ref-frame normals
    cost: np.ndarray           # (H, W)
    confidence: np.ndarray     # (H, W)
    reliable: np.ndarray       # (H, W) bool
    region_planes: np.ndarray  # (M, 4) fitted planes (0 for non-weak)
    depth_pm: np.ndarray       # (H, W) depth of the input (PatchMatch) state


def disparity_of(cams: geo.CameraSet, normal, d):
    H, W = d.shape
    xx, yy = geo.pixel_grid(H, W, d.device)
    return geo.disparity_depth(cams.f, cams.baseline,
                               geo.depth_from_plane(cams, normal, d, xx, yy))


def confidence_stage(imgs: torch.Tensor, view_ids: Sequence[int],
                     cams: geo.CameraSet, state: PlaneState,
                     params: AlgorithmParams):
    """Reverse cost at each pixel's best view, lrdiff = |c - rc| clamped,
    confidence ((2-c)/2 + (1-lrdiff))/2, and the disparity map."""
    rl = ncc.rl_cost_fused(imgs[0], imgs, state.best_view, view_ids, cams,
                           state.normal, state.d, params)
    lrdiff = torch.clamp(torch.abs(state.cost - rl), max=params.lr_diff_clamp)
    confid = ((2.0 - state.cost) / 2.0 + (1.0 - lrdiff)) / 2.0
    return confid, lrdiff, disparity_of(cams, state.normal, state.d)


def wmf_stage(ref_img: torch.Tensor, cams: geo.CameraSet,
              state: PlaneState, disp: torch.Tensor,
              reliable: torch.Tensor, params: AlgorithmParams,
              iters: int = 4) -> torch.Tensor:
    """Coarse-to-fine WMF outlier marking."""
    for it in range(iters):
        reliable = wmf.wmf_mark_outliers(ref_img, state.normal, state.d,
                                         disp, reliable, it, cams, params)
    return reliable


def fit_region_planes(generator: torch.Generator, weak: WeakTexture,
                      disp: torch.Tensor, reliable: np.ndarray,
                      cams: geo.CameraSet,
                      params: AlgorithmParams) -> np.ndarray:
    """RANSAC plane per trueweak region over its reliable pixels' 3-D
    points (rebased ref frame); (M, 4) with zero rows for other regions.
    Regions above ransac_max_points reliable pixels are subsampled
    uniformly. The host builds each region's mask and draws its random
    numbers; then one call fits every region (kernel B5 on the card) and
    one batched polish follows. A view without a region of 3 reliable
    points fits nothing (VIEWS_WITHOUT_REGIONS counts it)."""
    global VIEWS_WITHOUT_REGIONS
    from scipy import ndimage
    H, W = disp.shape
    dev = disp.device
    depth = geo.disparity_depth(cams.f, cams.baseline, disp)
    pts_all = ransac.region_points(depth, geo.pixel_rays(cams, H, W))
    labels = weak.labels_full
    planes = np.zeros((weak.num_regions, 4), np.float32)
    regions, pts, idx, deltas, thr0 = [], [], [], [], []
    for region in np.nonzero(weak.text == -1)[0]:
        rmask = labels == region
        if params.ransac_ring > 0:
            rmask = ndimage.binary_dilation(rmask,
                                            iterations=params.ransac_ring)
        ys, xs = np.nonzero(rmask & reliable)
        if ys.size < 3:
            continue
        sel = torch.as_tensor(ys * W + xs, device=dev)
        if ys.size > params.ransac_max_points:
            keep = torch.randperm(ys.size, generator=generator,
                                  device=dev)[:params.ransac_max_points]
            sel = sel[keep]
        p = pts_all.reshape(-1, 3)[sel]
        i, dl = ransac.draw_region(generator, p.shape[0],
                                   params.ransac_iters,
                                   params.ransac_anneal_rounds)
        regions.append(region)
        pts.append(p)
        idx.append(i)
        deltas.append(dl)
        thr0.append(ransac.initial_threshold(int(weak.size[region]),
                                             params.ransac_thr_base))
    if not regions:
        VIEWS_WITHOUT_REGIONS += 1
        return planes
    fit = ransac.fit_regions(ransac.pack_regions(
        pts, idx, deltas, thr0, params.ransac_thr_max,
        params.ransac_thr_step))
    planes[regions] = fit.plane.cpu().numpy()
    return planes


def _oriented_region_planes(cams: geo.CameraSet, region_planes, labels):
    """Each pixel's region plane, flipped (all four components) to face
    the camera: (normal (H, W, 3), d (H, W), plane_px (H, W, 4))."""
    H, W = labels.shape
    plane_px = region_planes[labels]
    n_r = plane_px[..., :3]
    d_r = plane_px[..., 3]
    flip = torch.sum(n_r * geo.view_vectors(cams, H, W), dim=-1) > 0.0
    return (torch.where(flip[..., None], -n_r, n_r),
            torch.where(flip, -d_r, d_r), plane_px)


def fill_stage(cams: geo.CameraSet, state: PlaneState,
               region_planes: torch.Tensor, labels: torch.Tensor,
               weak_region: torch.Tensor, reliable: torch.Tensor,
               params: AlgorithmParams):
    """Textureless fill: weak pixels with a region plane take it (cost 0,
    reliable). Returns (state, reliable, disparity)."""
    n_r, d_r, plane_px = _oriented_region_planes(cams, region_planes,
                                                 labels)
    fill = weak_region[labels] & torch.any(plane_px != 0.0, dim=-1)
    normal = torch.where(fill[..., None], n_r, state.normal)
    d = torch.where(fill, d_r, state.d)
    new_state = state._replace(normal=normal, d=d,
                               cost=torch.where(fill, 0.0, state.cost))
    return new_state, reliable | fill, disparity_of(cams, normal, d)


def fake_depth_stage(cams: geo.CameraSet, region_planes: torch.Tensor,
                     labels: torch.Tensor, weak_region: torch.Tensor,
                     params: AlgorithmParams) -> torch.Tensor:
    """The region plane's depth at weak pixels (0 elsewhere); feeds the
    border check."""
    n_r, d_r, _ = _oriented_region_planes(cams, region_planes, labels)
    H, W = labels.shape
    xx, yy = geo.pixel_grid(H, W, labels.device)
    depth = geo.depth_from_plane(cams, n_r, d_r, xx, yy)
    return torch.where(weak_region[labels], depth, 0.0)


def border_consistency_check(weak: WeakTexture, fake_depth: np.ndarray,
                             disp: np.ndarray, cams: geo.CameraSet
                             ) -> np.ndarray:
    """Per-region mean |depth jump| across the region border (host)."""
    labels = weak.labels_full
    depth = np.asarray(geo.disparity_depth(float(cams.f),
                                           float(cams.baseline),
                                           np.asarray(disp)))
    depdif = np.zeros(weak.num_regions)
    borlen = np.zeros(weak.num_regions)
    weak_px = (weak.text == -1)[labels]
    for axis, shift in ((1, 1), (1, -1), (0, 1), (0, -1)):
        nb_lab = np.roll(labels, shift, axis=axis)
        nb_depth = np.roll(depth, shift, axis=axis)
        edge = weak_px & (nb_lab != labels)
        if axis == 1:
            edge[:, 0 if shift == 1 else -1] = False
        else:
            edge[0 if shift == 1 else -1, :] = False
        np.add.at(borlen, labels[edge], 1)
        np.add.at(depdif, labels[edge],
                  np.abs(fake_depth[edge] - nb_depth[edge]))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(borlen > 0, depdif / borlen, 0.0)


def border_veto(cams: geo.CameraSet, region_planes: np.ndarray,
                weak: WeakTexture, disp: torch.Tensor,
                params: AlgorithmParams) -> np.ndarray:
    """Drop (zero) the region planes whose filled depth jumps more than
    border_check_thr * depth_min across the region border."""
    dev = disp.device
    fake = fake_depth_stage(
        cams, torch.as_tensor(region_planes, device=dev),
        torch.as_tensor(weak.labels_full, dtype=torch.int64, device=dev),
        torch.as_tensor(weak.text == -1, device=dev), params)
    jump = border_consistency_check(weak, fake.cpu().numpy(),
                                    disp.cpu().numpy(), cams)
    veto = jump > params.border_check_thr * params.depth_min
    return np.where(veto[:, None], 0.0, region_planes).astype(np.float32)


def wmf_final_stage(ref_img: torch.Tensor, cams: geo.CameraSet,
                    state: PlaneState, disp: torch.Tensor,
                    reliable: torch.Tensor, textured: torch.Tensor,
                    params: AlgorithmParams, iters: int = 6):
    """Fine WMF hole filling. Returns (state, disp, reliable)."""
    normal, d = state.normal, state.d
    for it in range(iters):
        normal, d, disp, reliable = wmf.wmf_fill(
            ref_img, normal, d, disp, reliable, textured, it, cams, params)
    return state._replace(normal=normal, d=d), disp, reliable


def prior_drift_revert(cams: geo.CameraSet, state: PlaneState,
                       prior_normal: torch.Tensor, prior_d: torch.Tensor,
                       drift_thr: float = 6.0) -> PlaneState:
    """Pixels whose refined disparity drifted more than `drift_thr` from
    the prior's take the prior plane back. Opt-in: no pipeline calls it
    (the reference's clause for it is never invoked either)."""
    revert = torch.abs(disparity_of(cams, state.normal, state.d)
                       - disparity_of(cams, prior_normal, prior_d)) \
        > drift_thr
    return state._replace(
        normal=torch.where(revert[..., None], prior_normal, state.normal),
        d=torch.where(revert, prior_d, state.d))


def finalize_stage(cams: geo.CameraSet, state: PlaneState):
    """World-frame normals and metric depth (0 where cost is MAXCOST)."""
    H, W = state.d.shape
    xx, yy = geo.pixel_grid(H, W, state.d.device)
    depth = geo.depth_from_plane(cams, state.normal, state.d, xx, yy)
    depth = torch.where(state.cost != ncc.MAXCOST, depth, 0.0)
    return depth, geo.matvec3(cams.R_orig_inv[0], state.normal)


def tsar_refine(imgs: torch.Tensor, cams: geo.CameraSet,
                view_ids: Sequence[int], params: AlgorithmParams,
                state: PlaneState, weak: WeakTexture,
                generator: torch.Generator, timer=None,
                reliable_seed: np.ndarray | None = None) -> TsarResult:
    """Full TSAR refinement of a PatchMatch (or lifted prior) plane field.
    imgs (V, H, W) f32 on the device. `reliable_seed` (H, W) bool seeds the
    reliability mask the WMF marking starts from (all true without one).
    `timer(name)`, when given, is called at each stage boundary with the
    name of the stage that just ended."""
    mark = timer or (lambda name: None)
    dev = imgs.device
    view_ids = tuple(int(v) for v in view_ids)
    H, W = imgs.shape[1:]
    confid, _, disp = confidence_stage(imgs, view_ids, cams, state, params)
    mark("confidence")
    reliable = (torch.ones((H, W), dtype=torch.bool, device=dev)
                if reliable_seed is None
                else torch.as_tensor(np.asarray(reliable_seed, bool),
                                     device=dev))
    reliable = wmf_stage(imgs[0], cams, state, disp, reliable, params,
                         iters=params.wmf_iters)
    mark("wmf_mark")
    region_planes = fit_region_planes(generator, weak, disp,
                                      reliable.cpu().numpy(), cams, params)
    mark("ransac")
    labels = torch.as_tensor(weak.labels_full, dtype=torch.int64,
                             device=dev)
    weak_region = torch.as_tensor(weak.text == -1, device=dev)
    if params.border_check:
        region_planes = border_veto(cams, region_planes, weak, disp, params)
    state2, reliable2, disp2 = fill_stage(
        cams, state, torch.as_tensor(region_planes, device=dev), labels,
        weak_region, reliable, params)
    mark("fill")
    textured = torch.as_tensor(weak.text == 1, device=dev)[labels]
    state2, disp2, reliable2 = wmf_final_stage(
        imgs[0], cams, state2, disp2, reliable2, textured, params,
        iters=params.wmf_final_iters)
    mark("wmf_final")
    depth, n_world = finalize_stage(cams, state2)
    result = TsarResult(depth=depth.cpu().numpy(),
                        normal_world=n_world.cpu().numpy(),
                        normal_cam=state2.normal.cpu().numpy(),
                        cost=state2.cost.cpu().numpy(),
                        confidence=confid.cpu().numpy(),
                        reliable=reliable2.cpu().numpy(),
                        region_planes=region_planes,
                        depth_pm=depth_map(state, cams).cpu().numpy())
    mark("finalize")
    return result
