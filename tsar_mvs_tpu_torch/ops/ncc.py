"""Bilaterally weighted NCC: reference-side statistics, the streaming view
aggregation and the reverse (confidence) cost. Port of the parts of
``tsar_mvs_tpu.ops.ncc`` that the s-volume path uses; the forward cost
itself lives in ``ops/svolume.py`` and its CUDA kernel.

Cost definition (identical to the reference): for window W(p) with
bilateral weights w_o = exp(-|o|/(2 s_spatial^2) - |I(p+o)-I(p)|/
(2 s_color^2)), cost = clamp(1 - NCC_w(ref, src), 0, cost_max), and
cost_max where either windowed variance < min_var. Window intensities
are centred on the window's centre pixel, which keeps float32 moments
well conditioned.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.geometry import CameraSet, pixel_grid, pixel_rays
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops.sampling import (bilinear_sample,
                                             bilinear_sample_packed,
                                             pack_image,
                                             shift_with_edge_clamp)

MAXCOST = 2.0


def window_offsets(params: AlgorithmParams) -> list[tuple[int, int]]:
    """(i, j) window offsets, i (x) outer, j (y) inner, stride
    win_increment."""
    return [(i, j)
            for i in range(-params.hrad, params.hrad + 1, params.win_increment)
            for j in range(-params.vrad, params.vrad + 1,
                           params.win_increment)]


class RefStats(NamedTuple):
    """Per-reference-image NCC precomputation shared by every candidate
    and source view (intensities centred on the window's centre pixel)."""

    center: torch.Tensor        # (H, W) I(p)
    ref_centered: torch.Tensor  # (O, H, W) I(p+o) - I(p), edge-clamped
    weights: torch.Tensor       # (O, H, W) bilateral weights
    inv_wsum: torch.Tensor      # (H, W) 1 / sum_o w_o
    mean_ref: torch.Tensor      # (H, W)
    var_ref: torch.Tensor       # (H, W)
    rays: torch.Tensor          # (H, W, 3) K^-1 p~
    k0: torch.Tensor            # (3,) d ray / dx
    k1: torch.Tensor            # (3,) d ray / dy


def precompute_ref_stats(ref_img: torch.Tensor, cams: CameraSet,
                         params: AlgorithmParams) -> RefStats:
    H, W = ref_img.shape
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    shifted, weights = [], []
    for (i, j) in window_offsets(params):
        ref_c = shift_with_edge_clamp(ref_img, j, i) - ref_img
        spatial = math.sqrt(i * i + j * j)
        shifted.append(ref_c)
        weights.append(torch.exp(-spatial * inv_2ss
                                 - torch.abs(ref_c) * inv_2sc))
    ref_centered = torch.stack(shifted)
    wts = torch.stack(weights)
    inv_wsum = 1.0 / torch.sum(wts, dim=0)
    mean_ref = torch.sum(wts * ref_centered, dim=0) * inv_wsum
    mean_ref_ref = torch.sum(wts * ref_centered * ref_centered,
                             dim=0) * inv_wsum
    return RefStats(center=ref_img, ref_centered=ref_centered, weights=wts,
                    inv_wsum=inv_wsum, mean_ref=mean_ref,
                    var_ref=mean_ref_ref - mean_ref * mean_ref,
                    rays=pixel_rays(cams, H, W),
                    k0=cams.K_inv[0][:, 0], k1=cams.K_inv[0][:, 1])


def compress_stats(stats: RefStats, parity: int) -> RefStats:
    """RefStats restricted to one parity class, packed (H, W/2)."""
    return RefStats(
        center=cb.parity_compress(stats.center, parity),
        ref_centered=cb.parity_compress(stats.ref_centered, parity),
        weights=cb.parity_compress(stats.weights, parity),
        inv_wsum=cb.parity_compress(stats.inv_wsum, parity),
        mean_ref=cb.parity_compress(stats.mean_ref, parity),
        var_ref=cb.parity_compress(stats.var_ref, parity),
        rays=cb.parity_compress_vec(stats.rays, parity),
        k0=stats.k0, k1=stats.k1)


def ncc_epilogue(sum_src: torch.Tensor, sum_src_src: torch.Tensor,
                 sum_ref_src: torch.Tensor, stats: RefStats,
                 params: AlgorithmParams) -> torch.Tensor:
    """Cost from the weighted window moments of centred source samples."""
    mean_src = sum_src * stats.inv_wsum
    var_src = sum_src_src * stats.inv_wsum - mean_src * mean_src
    covar = sum_ref_src * stats.inv_wsum - stats.mean_ref * mean_src
    ncc_cost = 1.0 - covar * torch.rsqrt(
        torch.clamp(stats.var_ref * var_src, min=1e-30))
    cost = torch.clamp(ncc_cost, 0.0, params.cost_max)
    low_var = (stats.var_ref < params.min_var) | (var_src < params.min_var)
    return torch.where(low_var, params.cost_max, cost)


class MultiviewCost(NamedTuple):
    cost: torch.Tensor       # (..., H, W) aggregated best-n cost
    best_view: torch.Tensor  # (..., H, W) int32 view id of min cost (-1 none)
    ratio: torch.Tensor      # (..., H, W) best / second-best ratio


def aggregate_streaming(per_view, ids: torch.Tensor) -> MultiviewCost:
    """n_best = 1 aggregation over per-view cost thunks: the running top-2
    min streams view by view, so one per-view cost is live at a time.
    Cost is the best per-view cost; ratio = best / second; best_view the
    argmin's id (-1 when no view is below MAXCOST). This is the second
    half of kernel B1's plain version (``cuda_ncc.multiview_cost_plain``);
    on the card the kernel keeps the top-2 itself."""
    best = per_view[0]()
    second = torch.full_like(best, MAXCOST)
    bidx = torch.zeros(best.shape, dtype=torch.int64, device=best.device)
    for k in range(1, len(per_view)):
        c = per_view[k]()
        is_new = c < best
        second = torch.where(is_new, best, torch.minimum(second, c))
        best = torch.where(is_new, c, best)
        bidx = torch.where(is_new, k, bidx)
    if len(per_view) == 1:
        second = best
    any_valid = best < MAXCOST
    ratio = torch.where(any_valid, best / second, 0.0)
    best_view = torch.where(any_valid, ids.to(best.device)[bidx], -1)
    return MultiviewCost(cost=best, best_view=best_view.to(torch.int32),
                         ratio=ratio)


def rl_cost_fused(ref_img: torch.Tensor, src_imgs: torch.Tensor,
                  best_view: torch.Tensor, view_ids, cams: CameraSet,
                  normal: torch.Tensor, d: torch.Tensor,
                  params: AlgorithmParams) -> torch.Tensor:
    """Reverse (source-to-reference) NCC cost at each pixel's best view,
    in one pass: per-pixel warp factors are selected from the view set and
    samples come from the stacked packed sources (index base
    best_view * H * W). Zero where best_view < 0."""
    H, W = ref_img.shape
    bv = best_view
    zero = torch.zeros((), dtype=torch.float32, device=ref_img.device)
    A_px = [[zero for _ in range(3)] for _ in range(3)]
    b_px = [zero for _ in range(3)]
    for v in view_ids:
        m = (bv == v).to(torch.float32)
        for r in range(3):
            for c in range(3):
                A_px[r][c] = A_px[r][c] + cams.A[v, r, c] * m
            b_px[r] = b_px[r] + cams.b[v, r] * m

    stack = torch.stack([pack_image(src_imgs[v]).data
                         for v in range(src_imgs.shape[0])]).reshape(-1, 4)
    packed = pack_image(ref_img)._replace(data=stack)
    base = torch.clamp(bv, min=0).to(torch.int64) * (H * W)

    def sample_src(x, y):
        return bilinear_sample_packed(packed, x, y, base=base)

    cost = _rl_cost_from_factors(ref_img, sample_src, A_px, b_px, cams,
                                 normal, d, params)
    return torch.where(bv >= 0, cost, 0.0)


def _rl_cost_from_factors(ref_img: torch.Tensor, sample_src, A, b,
                          cams: CameraSet, normal: torch.Tensor,
                          d: torch.Tensor,
                          params: AlgorithmParams) -> torch.Tensor:
    """Reverse NCC cost given per-pixel warp factors A (3x3 nested list)
    and b (3-list): the window is taken around the warped centre in the
    source and mapped back through the inverse homography."""
    H, W = ref_img.shape
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    Kinv = cams.K_inv[0]
    m = [Kinv[0, k] * normal[..., 0] + Kinv[1, k] * normal[..., 1]
         + Kinv[2, k] * normal[..., 2] for k in range(3)]
    inv_d = 1.0 / d
    Hm = [[A[r][k] - b[r] * m[k] * inv_d for k in range(3)]
          for r in range(3)]

    c00 = Hm[1][1] * Hm[2][2] - Hm[1][2] * Hm[2][1]
    c01 = Hm[1][2] * Hm[2][0] - Hm[1][0] * Hm[2][2]
    c02 = Hm[1][0] * Hm[2][1] - Hm[1][1] * Hm[2][0]
    det = Hm[0][0] * c00 + Hm[0][1] * c01 + Hm[0][2] * c02
    inv_det = 1.0 / det
    Vm = [[c00 * inv_det,
           (Hm[0][2] * Hm[2][1] - Hm[0][1] * Hm[2][2]) * inv_det,
           (Hm[0][1] * Hm[1][2] - Hm[0][2] * Hm[1][1]) * inv_det],
          [c01 * inv_det,
           (Hm[0][0] * Hm[2][2] - Hm[0][2] * Hm[2][0]) * inv_det,
           (Hm[0][2] * Hm[1][0] - Hm[0][0] * Hm[1][2]) * inv_det],
          [c02 * inv_det,
           (Hm[0][1] * Hm[2][0] - Hm[0][0] * Hm[2][1]) * inv_det,
           (Hm[0][0] * Hm[1][1] - Hm[0][1] * Hm[1][0]) * inv_det]]

    xx, yy = pixel_grid(H, W, ref_img.device)
    cz = Hm[2][0] * xx + Hm[2][1] * yy + Hm[2][2]
    cx_ = (Hm[0][0] * xx + Hm[0][1] * yy + Hm[0][2]) / cz
    cy_ = (Hm[1][0] * xx + Hm[1][1] * yy + Hm[1][2]) / cz
    cen_pix = sample_src(cx_, cy_)

    s_r = s_rr = s_s = s_ss = s_rs = s_w = torch.zeros_like(cx_)
    for (i, j) in window_offsets(params):
        spatial = math.sqrt(i * i + j * j)
        plx = cx_ + float(i)
        ply = cy_ + float(j)
        ref_pix = sample_src(plx, ply) - cen_pix
        prz = Vm[2][0] * plx + Vm[2][1] * ply + Vm[2][2]
        prx = (Vm[0][0] * plx + Vm[0][1] * ply + Vm[0][2]) / prz
        pry = (Vm[1][0] * plx + Vm[1][1] * ply + Vm[1][2]) / prz
        src_pix = bilinear_sample(ref_img, prx, pry) - cen_pix
        w = torch.exp(-spatial * inv_2ss - torch.abs(ref_pix) * inv_2sc)
        s_r = s_r + w * ref_pix
        s_rr = s_rr + w * ref_pix * ref_pix
        s_s = s_s + w * src_pix
        s_ss = s_ss + w * src_pix * src_pix
        s_rs = s_rs + w * ref_pix * src_pix
        s_w = s_w + w

    inv_wsum = 1.0 / s_w
    mr, mrr, ms, mss, mrs = [s * inv_wsum for s in (s_r, s_rr, s_s, s_ss,
                                                    s_rs)]
    var_ref = mrr - mr * mr
    var_src = mss - ms * ms
    covar = mrs - mr * ms
    cost = 1.0 - covar * torch.rsqrt(torch.clamp(var_ref * var_src,
                                                 min=1e-30))
    cost = torch.clamp(cost, 0.0, params.cost_max)
    low_var = (var_ref < params.min_var) | (var_src < params.min_var)
    return torch.where(low_var, params.cost_max, cost)
