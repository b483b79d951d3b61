"""Epipolar s-volume sampling for the PatchMatch hot loop (port of
``tsar_mvs_tpu.ops.svolume``).

The plane-induced warp q = (A p~ - b s) / (A p~ - b s)_z depends on the
candidate plane only through s = (n·ray)/d = -1/depth, so every cost
evaluation samples one 3-D field per source view, W_v(p, s) =
src_v(q(p, s)). Discretising s so adjacent planes move any pixel by at
most `step_px` along its epipolar line gives a per-view (S, H, W) volume,
and a window sample at offset o = (i, j) is W(p + o, s0 + i*sx + j*sy):
an integer offset of the volume plus linear interpolation along s.

On the card the build is kernel B2 (``ops/cuda_warp.py``) and the cost is
kernel B1 (``ops/cuda_ncc.py``); on the CPU both run their plain PyTorch
versions. The direct sampler (kernel B3) is the other one
(``ops/cuda_direct.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.ops import cuda_ncc, cuda_warp
from tsar_mvs_tpu_torch.ops.ncc import MultiviewCost, RefStats, plane_scalars


class SVolume(NamedTuple):
    """Per-view sweep volumes: data[v] is (S_v, H, W) bf16; the s interval
    [s_lo, s_hi] is shared, spacing ds_v = (s_hi - s_lo) / (S_v - 1)."""

    data: tuple
    s_lo: float
    inv_ds: tuple          # per-view f32-rounded 1 / ds_v

    @property
    def num_views(self) -> int:
        return len(self.data)


def s_range_for_depths(depth_min: float, depth_max: float,
                       margin: float = 0.0) -> tuple[float, float]:
    """[s_lo, s_hi] covering planes whose depth lies in [depth_min,
    depth_max] (s = -1/depth), widened by `margin` of its width."""
    lo, hi = -1.0 / depth_min, -1.0 / depth_max
    m = margin * (hi - lo)
    return lo - m, hi + m


def plane_counts(A: np.ndarray, b: np.ndarray, H: int, W: int,
                 s_lo: float, s_hi: float, step_px: float = 1.0,
                 max_planes: int = 1024,
                 budget_bytes: int | None = None,
                 bytes_per_voxel: int = 2) -> list[int]:
    """Per-view plane counts so adjacent planes move any pixel by at most
    `step_px` along its epipolar line (host side, float64). The maximum
    epipolar rate over s sits at an endpoint; the pixel extremum is
    sampled on a 9x9 grid. `budget_bytes` coarsens step_px by 1.5x until
    the volumes fit."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    if A.ndim == 2:
        A, b = A[None], b[None]
    xx, yy = np.meshgrid(np.linspace(0, W - 1, 9), np.linspace(0, H - 1, 9))
    p = np.stack([xx, yy, np.ones_like(xx)], -1)
    spans = []
    for v in range(A.shape[0]):
        u = np.einsum("ij,hwj->hwi", A[v], p)
        rate = 0.0
        for s in (s_lo, s_hi):
            w = u[..., 2] - b[v, 2] * s
            dx = (-b[v, 0] * w + u[..., 0] * b[v, 2]) / (w * w)
            dy = (-b[v, 1] * w + u[..., 1] * b[v, 2]) / (w * w)
            rate = max(rate, float(np.max(np.hypot(dx, dy))))
        spans.append(rate * (s_hi - s_lo))

    def counts(step):
        return [int(min(max_planes, max(2, math.ceil(sp / step) + 1)))
                for sp in spans]

    out = counts(step_px)
    if budget_bytes is not None:
        while (sum(out) * H * W * bytes_per_voxel > budget_bytes
               and step_px < 64.0):
            step_px *= 1.5
            out = counts(step_px)
    return out


def build_svolume(src_imgs: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                  s_lo: float, s_hi: float,
                  num_planes: Sequence[int]) -> SVolume:
    """One (S_v, H, W) bf16 volume per source view. src_imgs (V, H, W) f32
    source images (not the reference); A (V, 3, 3), b (V, 3)."""
    data, inv_ds = [], []
    for v in range(src_imgs.shape[0]):
        S_v = int(num_planes[v])
        ds = (s_hi - s_lo) / (S_v - 1)
        data.append(cuda_warp.build_svolume_view(src_imgs[v], A[v], b[v],
                                                 s_lo, ds, S_v))
        inv_ds.append(float(np.float32(1.0 / ds)))
    return SVolume(data=tuple(data), s_lo=float(np.float32(s_lo)),
                   inv_ds=tuple(inv_ds))


def multiview_cost_svolume(vol: SVolume, ids: torch.Tensor,
                           normal: torch.Tensor, d: torch.Tensor,
                           stats: RefStats, params: AlgorithmParams,
                           parity: int | None = None,
                           scalars=None) -> MultiviewCost:
    """n_best = 1 cost of the planes against every view, aggregated by
    the streaming top-2 (kernel B1: one launch for all views on the card,
    its plain version on the CPU). ids: (V,) view ids reported in
    best_view. `scalars`: the planes' (s0, sx, sy) when the caller has
    them (kernel B6's candidates), else computed here."""
    if params.n_best != 1:
        raise NotImplementedError("the s-volume path supports n_best == 1")
    s0, sx, sy = (plane_scalars(normal, d, stats) if scalars is None
                  else scalars)
    return cuda_ncc.multiview_cost(vol.data, vol.s_lo, vol.inv_ds, ids, s0,
                                   sx, sy, stats, params, parity)
