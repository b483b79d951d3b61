"""Region RANSAC plane fitting for textureless regions (port of
``tsar_mvs_tpu.models.ransac``).

Per region: 3-point RANSAC in rounds of 1000 hypotheses (one (N, 3) x
(3, B) product per round) under the reference's adaptive inlier
threshold, then annealing by random perturbation with sequential >=
accepts, then a total-least-squares polish on the inliers. All
products run in full float32 (TF32 is off, see the package init).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RANSAC_ROUND = 1000


class PlaneFit(NamedTuple):
    plane: torch.Tensor      # (4,) [a, b, c, d], |(a, b, c)| = 1
    inliers: torch.Tensor    # () inlier count at the final threshold
    threshold: torch.Tensor  # () final adaptive threshold


def _plane_from_triplet(p1, p2, p3):
    """Plane through 3 points, |n| = 1; degenerate triplets give n = 0 and
    d = inf, which counts no inliers."""
    n = torch.linalg.cross(p2 - p1, p3 - p1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    ok = norm > 1e-12
    n = torch.where(ok, n / torch.clamp(norm, min=1e-30), 0.0)
    d = torch.where(ok[..., 0], -torch.sum(n * p1, dim=-1), float("inf"))
    return torch.cat([n, d[..., None]], dim=-1)


def _count_inliers(points, planes, thr):
    """Inlier counts of (B, 4) planes over (N, 3) points: (B,) f32."""
    resid = torch.abs(points @ planes[:, :3].T + planes[None, :, 3])
    return torch.sum((resid < thr).to(torch.float32), dim=0)


def ransac_plane(generator: torch.Generator, points: torch.Tensor,
                 depth_abs0: float, iters: int = 10000,
                 anneal_rounds: int = 1000, thr_max: float = 0.003,
                 thr_step: float = 0.0001) -> PlaneFit:
    """Fit one plane to `points` (N, 3), N >= 3. depth_abs0 is the initial
    inlier threshold; it grows by thr_step up to thr_max once per round
    when the inlier ratio is below 0.3, or when growing it would gain more
    than 2% of the points."""
    dev = points.device
    N = points.shape[0]
    total = float(max(N, 1))
    plane = torch.tensor([0.0, 0.0, 1.0, -1.0], device=dev)
    count = torch.zeros((), device=dev)
    thr = torch.tensor(depth_abs0, dtype=torch.float32, device=dev)
    for _ in range(iters // RANSAC_ROUND):
        idx = torch.randint(0, max(N, 3), (RANSAC_ROUND, 3),
                            generator=generator, device=dev)
        planes = _plane_from_triplet(points[idx[:, 0]], points[idx[:, 1]],
                                     points[idx[:, 2]])
        counts = _count_inliers(points, planes, thr)
        bi = torch.argmax(counts)
        better = counts[bi] >= count
        plane = torch.where(better, planes[bi], plane)
        count = torch.where(better, counts[bi], count)
        grow_small = (count / total < 0.3) & (thr < thr_max)
        count2 = _count_inliers(points, plane[None], thr + thr_step)[0]
        grow_big = (~grow_small) & (count2 > count + 0.02 * total)
        thr = torch.where(grow_small | grow_big, thr + thr_step, thr)
        count = torch.where(grow_big, count2, count)

    # Annealing: per round, 4 shrinking scales of uniform perturbation
    # (abc by 1e-4, d by 1e-3 of the scale), each accepted on >= count.
    scales = torch.tensor([2000.0, 200.0, 20.0, 2.0], device=dev)
    unit = torch.tensor([1e-4, 1e-4, 1e-4, 1e-3], device=dev)
    u_all = torch.rand((anneal_rounds, 4, 4), generator=generator,
                       device=dev)
    delta_all = (u_all * scales[None, :, None]
                 - scales[None, :, None] / 2.0) * unit
    for r in range(anneal_rounds):
        for s in range(4):
            cand = plane + delta_all[r, s]
            cand = cand / torch.sqrt(torch.sum(cand[:3] * cand[:3]) + 1e-30)
            c = _count_inliers(points, cand[None], thr)[0]
            take = c >= count
            plane = torch.where(take, cand, plane)
            count = torch.where(take, c, count)

    # Total-least-squares polish on the inliers (kept on >= count).
    resid = torch.abs(points @ plane[:3] + plane[3])
    w = (resid < thr).to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=3.0)
    mean = torch.sum(points * w[:, None], dim=0) / wsum
    centered = (points - mean) * w[:, None]
    _, evecs = torch.linalg.eigh(centered.T @ centered)
    n_ls = evecs[:, 0]
    cand = torch.cat([n_ls, -torch.dot(n_ls, mean)[None]])
    c_ls = _count_inliers(points, cand[None], thr)[0]
    take = c_ls >= count
    plane = torch.where(take, cand, plane)
    count = torch.where(take, c_ls, count)
    return PlaneFit(plane=plane, inliers=count.to(torch.int32),
                    threshold=thr)


def region_points(depth: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """X = depth * K^-1 p~ for every pixel: (H, W, 3)."""
    return depth[..., None] * rays


def initial_threshold(region_size, thr_base: float = 0.0003) -> float:
    """thr_base * sqrt(size // 20), at least thr_base (float32, as the
    JAX package computes it)."""
    s = np.float32(np.floor(np.float32(region_size) / np.float32(20.0)))
    return float(np.float32(thr_base) * np.maximum(np.float32(1.0),
                                                   np.sqrt(s)))
