"""Color (float4-equivalent) bilateral NCC for `-color_processing` (port
of ``tsar_mvs_tpu.ops.ncc_color``).

The reference's color mode uploads RGBA float4 textures
(addImageToTextureFloatColor, main.cpp:1151-1185; enabled at
main.cpp:1445) and instantiates the kernels as gipuma_first<float4>
(gipuma.cu:1879-1884). Its *active* NCC cost however reads the texture
through `tex2D<float>` regardless of the template type (pmCost,
gipuma.cu:248,263) — a type-mismatched fetch from a float4 CUDA array,
which is undefined behavior, so exact numeric parity is unachievable.
This module implements the float4 design *intent* instead, documented
divergence (the same as the JAX package's):

* window samples are 3-channel vectors; the NCC moments accumulate over
  all (offset, channel) samples with the offset's bilateral weight (the
  natural vector extension of pmCost's scalar accumulation);
* the bilateral color distance is the L1 norm over channels — exactly
  the reference's `l1_norm(float4)` with a zero alpha channel
  (gipuma.cu:142-146, used by its color cost path at gipuma.cu:187).

With all three channels equal the costs reduce to the grayscale NCC
evaluated with sigma_color' = sigma_color/sqrt(3) (the L1 distance
triples). On the card the multi-view cost is kernel B3
(``ops/cuda_direct.py``) with three channels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.geometry import CameraSet, pixel_rays
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops.ncc import (MultiviewCost, aggregate,
                                        direct_cost, plane_scalars,
                                        window_offsets)
from tsar_mvs_tpu_torch.ops.sampling import (PackedImage, pack_image,
                                             shift_with_edge_clamp)


class ColorRefStats(NamedTuple):
    """Per-reference-image color-NCC precomputation (the channel-vector
    analogue of ncc.RefStats; channels lead each per-offset slice)."""

    center: torch.Tensor        # (3, H, W) I_c(p)
    ref_centered: torch.Tensor  # (O, 3, H, W) I_c(p+o) - I_c(p)
    weights: torch.Tensor       # (O, H, W) bilateral weights (per offset)
    inv_wsum: torch.Tensor      # (H, W) 1 / (3 sum_o w_o)
    mean_ref: torch.Tensor      # (H, W) weighted mean over (o, c) samples
    var_ref: torch.Tensor       # (H, W) weighted variance over (o, c)
    rays: torch.Tensor          # (H, W, 3)
    k0: torch.Tensor            # (3,)
    k1: torch.Tensor            # (3,)


def precompute_ref_stats_color(ref_rgb: torch.Tensor, cams: CameraSet,
                               params: AlgorithmParams) -> ColorRefStats:
    """ref_rgb: (3, H, W) float32."""
    _, H, W = ref_rgb.shape
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    shifted, weights = [], []
    for (i, j) in window_offsets(params):
        ref_c = shift_with_edge_clamp(ref_rgb, j, i) - ref_rgb  # (3, H, W)
        spatial = math.sqrt(i * i + j * j)
        l1 = torch.sum(torch.abs(ref_c), dim=0)
        weights.append(torch.exp(-spatial * inv_2ss - l1 * inv_2sc))
        shifted.append(ref_c)
    ref_centered = torch.stack(shifted)
    wts = torch.stack(weights)
    inv_wsum = 1.0 / (3.0 * torch.sum(wts, dim=0))
    w_oc = wts[:, None]
    mean_ref = torch.sum(w_oc * ref_centered, dim=(0, 1)) * inv_wsum
    mean_ref_ref = torch.sum(w_oc * ref_centered * ref_centered,
                             dim=(0, 1)) * inv_wsum
    return ColorRefStats(center=ref_rgb, ref_centered=ref_centered,
                         weights=wts, inv_wsum=inv_wsum, mean_ref=mean_ref,
                         var_ref=mean_ref_ref - mean_ref * mean_ref,
                         rays=pixel_rays(cams, H, W),
                         k0=cams.K_inv[0][:, 0], k1=cams.K_inv[0][:, 1])


def compress_stats_color(stats: ColorRefStats,
                         parity: int) -> ColorRefStats:
    """ColorRefStats restricted to one parity class, packed (H, W/2)."""
    return ColorRefStats(
        center=cb.parity_compress(stats.center, parity),
        ref_centered=cb.parity_compress(stats.ref_centered, parity),
        weights=cb.parity_compress(stats.weights, parity),
        inv_wsum=cb.parity_compress(stats.inv_wsum, parity),
        mean_ref=cb.parity_compress(stats.mean_ref, parity),
        var_ref=cb.parity_compress(stats.var_ref, parity),
        rays=cb.parity_compress_vec(stats.rays, parity),
        k0=stats.k0, k1=stats.k1)


def pack_image_color(rgb: torch.Tensor,
                     dtype=torch.bfloat16) -> tuple[PackedImage, ...]:
    """Per-channel 4-corner packing of a (3, H, W) image."""
    return tuple(pack_image(rgb[c], dtype) for c in range(3))


def pm_cost_ab_color(src_packed: Sequence[PackedImage], A: torch.Tensor,
                     b: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
                     stats: ColorRefStats, params: AlgorithmParams,
                     coords=None) -> torch.Tensor:
    """Color NCC cost against one source view (3 packed channels): the
    factored warp of ncc.pm_cost_ab, each window sample fetching all three
    channels at the same warped point."""
    s0, sx, sy = plane_scalars(normal, d, stats)
    return direct_cost(tuple(src_packed), A, b, s0, sx, sy, stats, params,
                       coords)


def multiview_cost_color(packed_by_view, view_ids: Sequence[int],
                         cams: CameraSet, normal: torch.Tensor,
                         d: torch.Tensor, stats: ColorRefStats,
                         params: AlgorithmParams,
                         coords=None) -> MultiviewCost:
    """Best-n aggregation over per-view color costs (pmCostMultiview_cu
    semantics). packed_by_view: {view_id: (3 PackedImages)}."""
    per_view = [lambda v=v: pm_cost_ab_color(packed_by_view[v], cams.A[v],
                                             cams.b[v], normal, d, stats,
                                             params, coords)
                for v in view_ids]
    return aggregate(per_view, torch.as_tensor(list(view_ids)), params)
