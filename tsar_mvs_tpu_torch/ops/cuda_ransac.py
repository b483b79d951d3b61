"""Kernel B5: the region RANSAC of one view.

``ransac_regions`` launches ``csrc/ransac.cu`` once for all regions of a
view, one block a region: the rounds of 1000 triplet hypotheses with the
adaptive threshold, then the annealing's sequential accepts, on the
regions' packed points and the draws made before the launch, as
``models/ransac.py::ransac_regions_plain`` computes them (the dispatch,
``ransac.ransac_regions``, takes the plain version for CPU tensors). It
replaces the JAX package's jitted ``ransac_plane``
(``tsar_mvs_tpu/models/ransac.py``: ``_plane_from_triplet``,
``_count_inliers`` and its two ``lax.scan``s) and the per-region loop of
``tsar_mvs_tpu/models/tsar.py`` ``fit_region_planes``; the JAX package has
no TPU kernel for it. Every float step is rounded on its own in the plain
version's order and the counts are integers, so the kernel equals its
plain version to the bit. This module imports nothing of
``models/ransac.py``.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from tsar_mvs_tpu_torch import _build

# Kernel launches since the last reset (read by chip_smoke.py), in all and
# by (regions, largest region's points) of the launch.
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

# Hypotheses a round (one thread each, csrc/ransac.cu) and threads a block.
HYPOTHESES = 1000
THREADS = 1024
# A region's count and hypothesis share one 32-bit key in the block's
# argmax.
MAX_POINTS = (1 << 21) - 1


def ransac_regions(points: torch.Tensor, offsets: torch.Tensor,
                   idx: torch.Tensor, deltas: torch.Tensor,
                   thr0: torch.Tensor, total: torch.Tensor,
                   gain: torch.Tensor, thr_max: float, thr_step: float,
                   ratio: float, eps: float, tiny: float):
    """(plane (R, 4) f32, count (R,) int32, threshold (R,) f32) of R
    regions in one launch: points (P, 3) f32, region r its rows
    offsets[r]:offsets[r+1] (int64, R + 1 of them, at least 3 points a
    region), idx (R, rounds, HYPOTHESES, 3) int32 triplets in [0, N_r),
    deltas (R, anneal_rounds, 4, 4) f32, thr0, total and gain (R,) f32,
    all on one CUDA device; thr_max, thr_step, ratio, eps and tiny
    float32 values, passed as they are."""
    global LAUNCHES
    if not points.is_cuda:
        raise ValueError("cuda_ransac.ransac_regions: CUDA tensors expected")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"cuda_ransac.ransac_regions: points must be (P, "
                         f"3), got {tuple(points.shape)}")
    R = offsets.shape[0] - 1 if offsets.dim() == 1 else 0
    if R < 1:
        raise ValueError("cuda_ransac.ransac_regions: offsets must be (R + "
                         "1,) with R >= 1")
    if (idx.dim() != 4 or idx.shape[0] != R or idx.shape[2:] !=
            (HYPOTHESES, 3) or deltas.dim() != 4 or deltas.shape[0] != R
            or deltas.shape[2:] != (4, 4)):
        raise ValueError(f"cuda_ransac.ransac_regions: idx must be (R, "
                         f"rounds, {HYPOTHESES}, 3) and deltas (R, rounds, "
                         f"4, 4) for R = {R}, got {tuple(idx.shape)} and "
                         f"{tuple(deltas.shape)}")
    if any(t.shape != (R,) for t in (thr0, total, gain)):
        raise ValueError("cuda_ransac.ransac_regions: thr0, total and gain "
                         "must be (R,)")
    tensors = (points, offsets, idx, deltas, thr0, total, gain)
    if any(t.device != points.device for t in tensors):
        raise ValueError("cuda_ransac.ransac_regions: tensors on different "
                         "devices")
    if any(t.dtype != torch.float32
           for t in (points, deltas, thr0, total, gain)):
        raise TypeError("cuda_ransac.ransac_regions: points, deltas, thr0, "
                        "total and gain must be float32")
    if offsets.dtype != torch.int64 or idx.dtype != torch.int32:
        raise TypeError("cuda_ransac.ransac_regions: offsets must be int64 "
                        "and idx int32")
    off = offsets.tolist()
    n = [b - a for a, b in zip(off[:-1], off[1:])]
    if off[0] != 0 or off[-1] != points.shape[0] or min(n) < 3 \
            or max(n) > MAX_POINTS:
        raise ValueError(f"cuda_ransac.ransac_regions: offsets {off[:4]}... "
                         f"must run from 0 to {points.shape[0]} with 3 to "
                         f"{MAX_POINTS} points a region")
    n_dev = torch.as_tensor(n, device=points.device)[:, None, None, None]
    if bool(((idx < 0) | (idx >= n_dev)).any()):
        raise ValueError("cuda_ransac.ransac_regions: a triplet index lies "
                         "outside its region")
    points, offsets, idx, deltas, thr0, total, gain = (
        t.contiguous() for t in tensors)
    dev = points.device
    plane = torch.empty((R, 4), dtype=torch.float32, device=dev)
    count = torch.empty(R, dtype=torch.int32, device=dev)
    thr = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    code = lib.tsar_ransac_regions(
        points.data_ptr(), offsets.data_ptr(), idx.data_ptr(),
        deltas.data_ptr(), thr0.data_ptr(), total.data_ptr(),
        gain.data_ptr(), R, idx.shape[1], deltas.shape[1], float(thr_max),
        float(thr_step), float(ratio), float(eps), float(tiny),
        plane.data_ptr(), count.data_ptr(), thr.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "tsar_ransac_regions")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(R, max(n))] += 1
    return plane, count, thr
