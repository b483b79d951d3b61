"""Bilaterally weighted NCC: reference-side statistics, the direct
sampler's forward cost, the view aggregations and the reverse
(confidence) cost (port of ``tsar_mvs_tpu.ops.ncc``). The s-volume
sampler's forward cost lives in ``ops/svolume.py``; on the card both
samplers' multi-view costs are kernels (B1 ``ops/cuda_ncc.py``, B3
``ops/cuda_direct.py``) whose plain versions are built from this module.

The direct cost evaluates the plane-induced warp in factored form,
q = A p~ + (i a0 + j a1) - b s with s = n·ray(p + o) / d, and takes one
bilinear gather of the bf16 4-corner-packed source per window sample.

Cost definition (identical to the reference): for window W(p) with
bilateral weights w_o = exp(-|o|/(2 s_spatial^2) - |I(p+o)-I(p)|/
(2 s_color^2)), cost = clamp(1 - NCC_w(ref, src), 0, cost_max), and
cost_max where either windowed variance < min_var. Window intensities
are centred on the window's centre pixel, which keeps float32 moments
well conditioned.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.geometry import CameraSet, pixel_grid, pixel_rays
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops.sampling import (PackedImage, bilinear_sample,
                                             bilinear_sample_packed,
                                             pack_image)

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
    """The statistics of every window offset at once: one gather of the
    edge-clamped offset pixels and elementwise ops over (O, H, W), each
    value what shift_with_edge_clamp and the per-offset weight give (a
    few launches a level instead of some ten an offset)."""
    H, W = ref_img.shape
    dev = ref_img.device
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    offs = window_offsets(params)
    di = torch.tensor([i for i, _ in offs], device=dev)
    dj = torch.tensor([j for _, j in offs], device=dev)
    iy = torch.clamp(torch.arange(H, device=dev)[None, :] + dj[:, None], 0,
                     H - 1)
    ix = torch.clamp(torch.arange(W, device=dev)[None, :] + di[:, None], 0,
                     W - 1)
    ref_centered = ref_img[iy[:, :, None], ix[:, None, :]] - ref_img
    # -|o| / (2 s_spatial^2) per offset, rounded to float32 as torch rounds
    # the Python float of the per-offset expression.
    spatial = torch.tensor([-math.sqrt(i * i + j * j) * inv_2ss
                            for i, j in offs], dtype=torch.float32,
                           device=dev)[:, None, None]
    wts = torch.exp(spatial - torch.abs(ref_centered) * inv_2sc)
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


def plane_scalars(normal: torch.Tensor, d: torch.Tensor, stats
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s0, sx, sy): s0 = n·ray/d and its exact window derivatives (stats:
    RefStats or ncc_color.ColorRefStats)."""
    inv_d = 1.0 / d
    s0 = torch.sum(normal * stats.rays, dim=-1) * inv_d
    sx = (normal[..., 0] * stats.k0[0] + normal[..., 1] * stats.k0[1]
          + normal[..., 2] * stats.k0[2]) * inv_d
    sy = (normal[..., 0] * stats.k1[0] + normal[..., 1] * stats.k1[1]
          + normal[..., 2] * stats.k1[2]) * inv_d
    return s0, sx, sy


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


def direct_cost(src: Sequence[PackedImage], A: torch.Tensor,
                b: torch.Tensor, s0: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor, stats, params: AlgorithmParams,
                coords=None) -> torch.Tensor:
    """Direct-sampler cost of plane scalars (s0, sx, sy) (..., Hc, Wc)
    against one source view with warp factors A = K_s R K_ref^-1 (3, 3) and
    b = K_s t (3,). `src` holds the view's channels as bf16 PackedImages:
    one with RefStats, three with ncc_color.ColorRefStats, whose moments
    run over (offset, channel). `coords=(xx, yy)` are the output
    positions' reference-pixel coordinates (default the dense grid of
    `stats`). A candidate whose plane coordinate is non-finite at any
    offset (d = 0 padding) costs cost_max. This is kernel B3's arithmetic
    per view, in its order."""
    if coords is None:
        Hc, Wc = stats.mean_ref.shape
        xx = torch.arange(Wc, dtype=torch.float32, device=s0.device)[None, :]
        yy = torch.arange(Hc, dtype=torch.float32, device=s0.device)[:, None]
    else:
        xx, yy = coords
    color = len(src) > 1
    centers = list(stats.center) if color else [stats.center]
    Ap = [A[r, 0] * xx + A[r, 1] * yy + A[r, 2] for r in range(3)]
    acc_s = acc_ss = acc_rs = torch.zeros_like(s0)
    bad = torch.zeros(s0.shape, dtype=torch.bool, device=s0.device)
    for o, (i, j) in enumerate(window_offsets(params)):
        s = s0 + float(i) * sx + float(j) * sy
        bad = bad | ~torch.isfinite(s)
        qx = (Ap[0] + (float(i) * A[0, 0] + float(j) * A[0, 1])) - b[0] * s
        qy = (Ap[1] + (float(i) * A[1, 0] + float(j) * A[1, 1])) - b[1] * s
        qz = (Ap[2] + (float(i) * A[2, 0] + float(j) * A[2, 1])) - b[2] * s
        inv_qz = 1.0 / qz
        w = stats.weights[o]
        for c, packed in enumerate(src):
            smp = bilinear_sample_packed(packed, qx * inv_qz,
                                         qy * inv_qz) - centers[c]
            ws = w * smp
            acc_s = acc_s + ws
            acc_ss = acc_ss + ws * smp
            acc_rs = acc_rs + ws * (stats.ref_centered[o, c] if color
                                    else stats.ref_centered[o])
    cost = ncc_epilogue(acc_s, acc_ss, acc_rs, stats, params)
    return torch.where(bad, params.cost_max, cost)


def pm_cost_ab(src_img: PackedImage, A: torch.Tensor, b: torch.Tensor,
               normal: torch.Tensor, d: torch.Tensor, stats: RefStats,
               params: AlgorithmParams, coords=None) -> torch.Tensor:
    """NCC cost of the plane field (normal (..., Hc, Wc, 3), d (..., Hc,
    Wc)) against one source view, packed in bf16 (pack_image(...,
    torch.bfloat16)); `coords` as in direct_cost. Returns (..., Hc, Wc)."""
    s0, sx, sy = plane_scalars(normal, d, stats)
    return direct_cost((src_img,), A, b, s0, sx, sy, stats, params, coords)


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


def aggregate_view_costs(costs: torch.Tensor, ids: torch.Tensor,
                         params: AlgorithmParams) -> MultiviewCost:
    """Best-n aggregation over the leading view axis of costs (V, ...):
    cost = mean of the best min(n_best, #valid) view costs (a view is
    valid below MAXCOST), MAXCOST with no valid view; ratio = sorted[0] /
    sorted[1] (sorted[0] with one view), 0 with no valid view; best_view =
    the id of the first argmin, -1 with no valid view. n_best == 1 is the
    streaming top-2. The sum runs in sorted order, one view at a time, as
    kernel B3 keeps it."""
    V = costs.shape[0]
    ids = ids.to(costs.device)
    if params.n_best == 1:
        return aggregate_streaming([lambda k=k: costs[k] for k in range(V)],
                                   ids)
    sorted_costs = torch.sort(costs, dim=0).values
    num_valid = torch.sum(costs < MAXCOST, dim=0)
    num_best = torch.clamp(num_valid, max=params.n_best)
    best_sum = sorted_costs[0] * (num_best > 0)
    for k in range(1, V):
        best_sum = best_sum + sorted_costs[k] * (num_best > k)
    any_valid = num_best > 0
    cost = torch.where(any_valid,
                       best_sum / torch.clamp(num_best, min=1).to(
                           costs.dtype), MAXCOST)
    second = sorted_costs[1] if V > 1 else sorted_costs[0]
    ratio = torch.where(any_valid, sorted_costs[0] / second, 0.0)
    best_view = torch.where(any_valid, ids[torch.argmin(costs, dim=0)], -1)
    return MultiviewCost(cost=cost, best_view=best_view.to(torch.int32),
                         ratio=ratio)


def aggregate(per_view, ids: torch.Tensor,
              params: AlgorithmParams) -> MultiviewCost:
    """Aggregate per-view cost thunks: streaming top-2 for n_best == 1,
    else the stacked best-n of aggregate_view_costs."""
    if params.n_best == 1:
        return aggregate_streaming(per_view, ids)
    return aggregate_view_costs(torch.stack([f() for f in per_view]), ids,
                                params)


def multiview_cost(src_imgs, view_ids: Sequence[int], cams: CameraSet,
                   normal: torch.Tensor, d: torch.Tensor, stats: RefStats,
                   params: AlgorithmParams, coords=None) -> MultiviewCost:
    """Direct-sampler multi-view cost (pmCostMultiview_cu): src_imgs[v] is
    view v's bf16 PackedImage, view_ids the source views."""
    per_view = [lambda v=v: pm_cost_ab(src_imgs[v], cams.A[v], cams.b[v],
                                       normal, d, stats, params, coords)
                for v in view_ids]
    return aggregate(per_view, torch.as_tensor(list(view_ids)), params)


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


def rl_cost_fused_traced(ref_img: torch.Tensor, src_imgs: torch.Tensor,
                         best_view: torch.Tensor, src_ids: torch.Tensor,
                         src_valid: torch.Tensor, A: torch.Tensor,
                         b: torch.Tensor, cams: CameraSet,
                         normal: torch.Tensor, d: torch.Tensor,
                         params: AlgorithmParams) -> torch.Tensor:
    """`rl_cost_fused` with per-slot warp factors, for the view-sharded
    confidence stage. The JAX package's name is kept: there the factors
    were traced so one compiled program served every reference; here
    nothing is traced, and the factors come from a SceneBatch row instead
    of `cams`.

    src_imgs: (S, H, W) source images in slot order; src_ids: (S,) image
    ids in best_view's id space; src_valid: (S,) slot mask; A: (S, 3, 3),
    b: (S, 3). Zero where no valid slot matches best_view."""
    H, W = ref_img.shape
    S = src_imgs.shape[0]
    bv = best_view
    masks = [((bv == src_ids[s]) & src_valid[s]).to(torch.float32)
             for s in range(S)]
    any_live = sum(masks) > 0
    zero = torch.zeros((), dtype=torch.float32, device=ref_img.device)
    A_px = [[zero for _ in range(3)] for _ in range(3)]
    b_px = [zero for _ in range(3)]
    slot = torch.zeros((H, W), dtype=torch.float32, device=ref_img.device)
    for s in range(S):
        m = masks[s]
        slot = slot + float(s) * m
        for r in range(3):
            for c in range(3):
                A_px[r][c] = A_px[r][c] + A[s, r, c] * m
            b_px[r] = b_px[r] + b[s, r] * m

    stack = torch.stack([pack_image(src_imgs[s]).data
                         for s in range(S)]).reshape(-1, 4)
    packed = pack_image(ref_img)._replace(data=stack)
    base = slot.to(torch.int64) * (H * W)

    def sample_src(x, y):
        return bilinear_sample_packed(packed, x, y, base=base)

    cost = _rl_cost_from_factors(ref_img, sample_src, A_px, b_px, cams,
                                 normal, d, params)
    return torch.where(any_live, cost, 0.0)


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
