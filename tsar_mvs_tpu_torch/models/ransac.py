"""Region RANSAC plane fitting for textureless regions (port of
``tsar_mvs_tpu.models.ransac``).

Per region: 3-point RANSAC in rounds of 1000 hypotheses under the
reference's adaptive inlier threshold, then annealing by random
perturbation with sequential >= accepts, then a total-least-squares
polish on the inliers.

All regions of a view go through one call. Their random draws are made
up front (`draw_region`: triplet indices and annealing perturbations) and
packed with the points (`pack_regions`), so the rounds and the annealing
are a deterministic function of their inputs: `ransac_regions` runs it in
kernel B5 (``ops/cuda_ransac.py``, ``csrc/ransac.cu``) for CUDA tensors
and in the plain version `ransac_regions_plain` for CPU tensors. Every
float step of that function runs in one fixed order and is rounded on its
own (the residual ((x a + y b) + z c) + d elementwise, the cross product
component by component, no BLAS product and no torch.sum of floats), and
every constant is rounded to float32 once on the host, so the kernel
equals the plain version to the bit. Inlier counts are exact integers.
The polish (`polish`) runs in torch, batched over the regions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsar_mvs_tpu_torch.ops import cuda_ransac

RANSAC_ROUND = cuda_ransac.HYPOTHESES
# The threshold grows while the inlier ratio is below RATIO, or when
# growing it gains more than GAIN of the points.
RATIO = float(np.float32(0.3))
GAIN = 0.02
# Added under the annealing candidate's norm; a triplet whose normal is
# not longer than TINY is degenerate.
EPS = float(np.float32(1e-30))
TINY = float(np.float32(1e-12))
# Annealing: 4 shrinking scales of uniform perturbation, abc by 1e-4 and
# d by 1e-3 of the scale.
SCALES = (2000.0, 200.0, 20.0, 2.0)
UNIT = (1e-4, 1e-4, 1e-4, 1e-3)
# Elements of one (regions, hypotheses, points) block of the plain
# version's residuals.
_CHUNK = 1 << 24


class PlaneFit(NamedTuple):
    plane: torch.Tensor      # (..., 4) [a, b, c, d], |(a, b, c)| = 1
    inliers: torch.Tensor    # (...) int32 inlier count at the final threshold
    threshold: torch.Tensor  # (...) final adaptive threshold


class RansacInputs(NamedTuple):
    """The regions of one view and their draws, all on one device."""
    points: torch.Tensor   # (P, 3) f32, the regions' points one after another
    offsets: torch.Tensor  # (R + 1,) int64, region r is points[o[r]:o[r+1]]
    idx: torch.Tensor      # (R, rounds, RANSAC_ROUND, 3) int32 triplets
    deltas: torch.Tensor   # (R, anneal_rounds, 4, 4) f32 perturbations
    thr0: torch.Tensor     # (R,) f32 initial thresholds
    total: torch.Tensor    # (R,) f32 point counts
    gain: torch.Tensor     # (R,) f32 GAIN * total, rounded once
    thr_max: float         # float32 values
    thr_step: float


def _f32(x: float) -> float:
    return float(np.float32(x))


def _residual(x, y, z, plane):
    """|((x a + y b) + z c) + d| elementwise; `plane`'s last axis holds
    (a, b, c, d) and broadcasts against x, y, z with that axis dropped."""
    a, b, c, d = plane.unbind(-1)
    return torch.abs(((x * a + y * b) + z * c) + d)


def _plane_from_triplet(p1, p2, p3):
    """Plane through 3 points (..., 3), |n| = 1; degenerate triplets give
    n = 0 and d = inf, which counts no inliers."""
    ex, ey, ez = (p2 - p1).unbind(-1)
    fx, fy, fz = (p3 - p1).unbind(-1)
    nx = ey * fz - ez * fy
    ny = ez * fx - ex * fz
    nz = ex * fy - ey * fx
    norm = torch.sqrt((nx * nx + ny * ny) + nz * nz)
    ok = norm > TINY
    m = torch.clamp(norm, min=EPS)
    nx, ny, nz = (torch.where(ok, v / m, 0.0) for v in (nx, ny, nz))
    px, py, pz = p1.unbind(-1)
    d = torch.where(ok, -((nx * px + ny * py) + nz * pz), float("inf"))
    return torch.stack([nx, ny, nz, d], dim=-1)


def padded(points: torch.Tensor, offsets: torch.Tensor):
    """The packed regions as (R, M, 3) with M the largest region, and the
    (R, M) mask of real points (padding repeats point 0)."""
    off = offsets.tolist()
    n = torch.as_tensor(np.diff(off), device=points.device)
    j = torch.arange(max(np.diff(off)), device=points.device)
    valid = j[None, :] < n[:, None]
    return points[torch.where(valid, offsets[:-1, None] + j, 0)], valid


def _counts(x, y, z, valid, planes, thr):
    """(R, B) int64 inlier counts of planes (R, B, 4) over the padded
    regions' coordinates (R, M) at thresholds (R,)."""
    R, B, _ = planes.shape
    step = max(1, _CHUNK // max(1, R * x.shape[1]))
    out = []
    for s in range(0, B, step):
        pl = planes[:, s:s + step, None, :]
        inl = _residual(x[:, None], y[:, None], z[:, None], pl) \
            < thr[:, None, None]
        out.append((inl & valid[:, None]).sum(-1))
    return torch.cat(out, dim=1)


def ransac_regions_plain(inp: RansacInputs):
    """The rounds and the annealing of every region: (plane (R, 4) f32,
    count (R,) int32, threshold (R,) f32), in kernel B5's arithmetic."""
    pts, valid = padded(inp.points, inp.offsets)
    x, y, z = pts.unbind(-1)
    R, rounds = inp.idx.shape[:2]
    dev = pts.device
    rr = torch.arange(R, device=dev)
    hyp = torch.arange(RANSAC_ROUND, device=dev)
    plane = torch.tensor([0.0, 0.0, 1.0, -1.0],
                         device=dev).expand(R, 4).clone()
    count = torch.zeros(R, dtype=torch.int64, device=dev)
    thr = inp.thr0.clone()
    for k in range(rounds):
        ix = inp.idx[:, k].long()
        planes = _plane_from_triplet(*(pts[rr[:, None], ix[..., i]]
                                       for i in range(3)))
        counts = _counts(x, y, z, valid, planes, thr)
        best = counts.max(dim=1).values
        # The first hypothesis among those with the most inliers.
        bi = torch.where(counts == best[:, None], hyp,
                         RANSAC_ROUND).min(dim=1).values
        better = best >= count
        plane = torch.where(better[:, None], planes[rr, bi], plane)
        count = torch.where(better, best, count)
        cf = count.to(torch.float32)
        grow_small = (cf / inp.total < RATIO) & (thr < inp.thr_max)
        t2 = thr + inp.thr_step
        count2 = _counts(x, y, z, valid, plane[:, None], t2)[:, 0]
        grow_big = ~grow_small & (count2.to(torch.float32) > cf + inp.gain)
        thr = torch.where(grow_small | grow_big, t2, thr)
        count = torch.where(grow_big, count2, count)
    for r in range(inp.deltas.shape[1]):
        for s in range(4):
            cand = plane + inp.deltas[:, r, s]
            c0, c1, c2, _ = cand.unbind(-1)
            cand = cand / torch.sqrt(((c0 * c0 + c1 * c1) + c2 * c2)
                                     + EPS)[:, None]
            c = _counts(x, y, z, valid, cand[:, None], thr)[:, 0]
            take = c >= count
            plane = torch.where(take[:, None], cand, plane)
            count = torch.where(take, c, count)
    return plane, count.to(torch.int32), thr


def ransac_regions(inp: RansacInputs):
    """`ransac_regions_plain`'s result: kernel B5 in one call for CUDA
    tensors, the plain version for CPU tensors."""
    if inp.points.is_cuda:
        return cuda_ransac.ransac_regions(
            inp.points, inp.offsets, inp.idx, inp.deltas, inp.thr0,
            inp.total, inp.gain, inp.thr_max, inp.thr_step, RATIO, EPS,
            TINY)
    return ransac_regions_plain(inp)


def polish(inp: RansacInputs, plane, count, thr):
    """Total-least-squares polish of every region on its inliers, kept on
    >= count: the smallest eigenvector of the weighted scatter matrix,
    one batched eigh. Returns (plane (R, 4), count (R,) int64)."""
    pts, valid = padded(inp.points, inp.offsets)
    x, y, z = pts.unbind(-1)
    w = ((_residual(x, y, z, plane[:, None]) < thr[:, None])
         & valid)[..., None]
    wsum = torch.clamp(w.sum(1).to(torch.float32), min=3.0)
    # Masked by selection, not by a product: a non-finite point (never an
    # inlier) must not make the scatter matrix NaN.
    mean = torch.where(w, pts, 0.0).sum(1) / wsum
    centered = torch.where(w, pts - mean[:, None], 0.0)
    _, evecs = torch.linalg.eigh(centered.transpose(1, 2) @ centered)
    n_ls = evecs[..., 0]
    cand = torch.cat([n_ls, -(n_ls * mean).sum(-1, keepdim=True)], dim=-1)
    c_ls = ((_residual(x, y, z, cand[:, None]) < thr[:, None])
            & valid).sum(1)
    take = c_ls >= count
    return (torch.where(take[:, None], cand, plane),
            torch.where(take, c_ls, count.to(torch.int64)))


def fit_regions(inp: RansacInputs) -> PlaneFit:
    """RANSAC, annealing and polish of every region: (R, 4), (R,), (R,)."""
    plane, count, thr = ransac_regions(inp)
    plane, count = polish(inp, plane, count, thr)
    return PlaneFit(plane=plane, inliers=count.to(torch.int32),
                    threshold=thr)


def draw_region(generator: torch.Generator, n: int, iters: int,
                anneal_rounds: int):
    """The draws of one region of n points: triplet indices
    (iters // RANSAC_ROUND, RANSAC_ROUND, 3) int32 in [0, max(n, 3)) and
    the annealing's perturbations (anneal_rounds, 4, 4) f32."""
    dev = generator.device
    idx = torch.randint(0, max(n, 3), (iters // RANSAC_ROUND,
                                       RANSAC_ROUND, 3),
                        generator=generator, device=dev, dtype=torch.int32)
    u = torch.rand((anneal_rounds, 4, 4), generator=generator, device=dev)
    return idx, deltas_from_uniform(u)


def deltas_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The annealing's perturbations (rounds, 4, 4) from uniforms in
    [0, 1): scale s of round r moves component k by
    (u s - s / 2) UNIT[k]."""
    scales = torch.tensor(SCALES, device=u.device)
    unit = torch.tensor(UNIT, device=u.device)
    return (u * scales[None, :, None] - scales[None, :, None] / 2.0) * unit


def pack_regions(points: list, idx: list, deltas: list, thr0: list,
                 thr_max: float, thr_step: float) -> RansacInputs:
    """One view's regions (each (N, 3) points with N >= 3, its draws and
    its initial threshold) as one RansacInputs."""
    dev = points[0].device
    n = np.array([p.shape[0] for p in points], np.int64)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return RansacInputs(
        points=torch.cat(points).to(torch.float32).contiguous(),
        offsets=torch.as_tensor(np.concatenate([[0], np.cumsum(n)]),
                                device=dev),
        idx=torch.stack(idx).contiguous(),
        deltas=torch.stack(deltas).to(torch.float32).contiguous(),
        thr0=f32(thr0), total=f32(n), gain=f32(GAIN * n),
        thr_max=_f32(thr_max), thr_step=_f32(thr_step))


def ransac_plane(generator: torch.Generator, points: torch.Tensor,
                 depth_abs0: float, iters: int = 10000,
                 anneal_rounds: int = 1000, thr_max: float = 0.003,
                 thr_step: float = 0.0001) -> PlaneFit:
    """Fit one plane to `points` (N, 3), N >= 3 (`fit_regions` of one
    region). depth_abs0 is the initial inlier threshold; it grows by
    thr_step up to thr_max once per round when the inlier ratio is below
    0.3, or when growing it would gain more than 2% of the points."""
    idx, deltas = draw_region(generator, points.shape[0], iters,
                              anneal_rounds)
    fit = fit_regions(pack_regions([points], [idx], [deltas], [depth_abs0],
                                   thr_max, thr_step))
    return PlaneFit(*(t[0] for t in fit))


def region_points(depth: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """X = depth * K^-1 p~ for every pixel: (H, W, 3)."""
    return depth[..., None] * rays


def initial_threshold(region_size, thr_base: float = 0.0003) -> float:
    """thr_base * sqrt(size // 20), at least thr_base (float32, as the
    JAX package computes it)."""
    s = np.float32(np.floor(np.float32(region_size) / np.float32(20.0)))
    return float(np.float32(thr_base) * np.maximum(np.float32(1.0),
                                                   np.sqrt(s)))
