"""Kernel B5: the region RANSAC of one view.

``ransac_regions`` runs ``csrc/ransac.cu`` once for all regions of a view
(one call, a short sequence of launches on the current stream): each
round's 1000 triplet hypotheses counted over the whole card, the points
cut into the chunks of ``round_chunks``, then one decide block a region
(the argmax, the accept and the adaptive threshold); then the annealing's
sequential accepts, a cluster of blocks a large region holding its points
in shared memory and resolving several steps a pass (``anneal_units``).
Its inputs are the regions' packed points and the draws made before the
call, and it computes what ``models/ransac.py::ransac_regions_plain``
computes (the dispatch, ``ransac.ransac_regions``, takes the plain
version for CPU tensors). It replaces the JAX package's jitted
``ransac_plane`` (``tsar_mvs_tpu/models/ransac.py``:
``_plane_from_triplet``, ``_count_inliers`` and its two ``lax.scan``s) and
the per-region loop of ``tsar_mvs_tpu/models/tsar.py``
``fit_region_planes``; the JAX package has no TPU kernel for it. Every
float step is rounded on its own in the plain version's order and the
counts are integers, so the kernel equals its plain version to the bit.
This module imports nothing of ``models/ransac.py``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from tsar_mvs_tpu_torch import _build

# Calls since the last reset (read by chip_smoke.py), one a view however
# many CUDA launches it makes, in all and by (regions, largest region's
# points).
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

# Mirrors of csrc/ransac.cu's constants: hypotheses a round and the decide
# block's threads; the rounds' chunks (at least CHUNK_MIN points, about
# CHUNK_BLOCKS_PER_SM blocks an SM); the annealing's blocks a cluster,
# steps a pass, points a block holds in shared memory at most, and the
# smallest region that takes a whole cluster.
HYPOTHESES = 1000
THREADS = 1024
CHUNK_MIN = 256
CHUNK_BLOCKS_PER_SM = 3
CLUSTER = 16
LOOKAHEAD = 2
SMEM_POINTS = 12288
CLUSTER_MIN_POINTS = 2048
# A region's count and hypothesis share one 32-bit key in the argmax.
MAX_POINTS = (1 << 21) - 1


def round_chunks(n, sms: int) -> list[tuple[int, int, int]]:
    """The rounds' work plan for regions of n points packed one after
    another: (first region, start, end) of each block's points, absolute
    indices into the packed points. A chunk holds at most `size` points,
    size = max(CHUNK_MIN, ceil(sum(n) / (CHUNK_BLOCKS_PER_SM sms))): a
    larger region is cut into near-equal pieces, smaller ones are merged
    whole, in order, while they fit."""
    n = [int(m) for m in n]
    size = max(CHUNK_MIN, -(-sum(n) // (CHUNK_BLOCKS_PER_SM * sms)))
    chunks: list[tuple[int, int, int]] = []
    run = None
    off = 0
    for r, m in enumerate(n):
        if m > size:
            if run:
                chunks.append(tuple(run))
                run = None
            k = -(-m // size)
            chunks.extend((r, off + m * i // k, off + m * (i + 1) // k)
                          for i in range(k))
        elif run and run[2] - run[1] + m <= size:
            run[2] += m
        else:
            if run:
                chunks.append(tuple(run))
            run = [r, off, off + m]
        off += m
    if run:
        chunks.append(tuple(run))
    return chunks


def anneal_units(n, cluster: int = CLUSTER):
    """The annealing's work plan: (region, blocks of its unit) for each
    block of the launch, whose clusters are `cluster` blocks in order, and
    the points a block holds in shared memory. A region of more than
    CLUSTER_MIN_POINTS points takes a whole cluster (rank q holds points
    [q S, (q + 1) S), S = ceil(N / cluster)); the others one block each,
    `cluster` of them to a cluster, idle blocks (-1, 1) filling the last.
    A block whose slice is larger than SMEM_POINTS reads it from global
    memory; the rest fit the shared memory of the largest of them."""
    n = [int(m) for m in n]
    big = [r for r, m in enumerate(n)
           if m > CLUSTER_MIN_POINTS and cluster > 1]
    small = [r for r in range(len(n)) if r not in set(big)]
    units = [(r, cluster) for r in big for _ in range(cluster)]
    for i in range(0, len(small), cluster):
        group = small[i:i + cluster]
        units += [(r, 1) for r in group] + [(-1, 1)] * (cluster - len(group))
    slices = [-(-n[r] // nb) for r, nb in units if r >= 0]
    return units, max((s for s in slices if s <= SMEM_POINTS), default=0)


def ransac_regions(points: torch.Tensor, offsets: torch.Tensor,
                   idx: torch.Tensor, deltas: torch.Tensor,
                   thr0: torch.Tensor, total: torch.Tensor,
                   gain: torch.Tensor, thr_max: float, thr_step: float,
                   ratio: float, eps: float, tiny: float):
    """(plane (R, 4) f32, count (R,) int32, threshold (R,) f32) of R
    regions in one call: points (P, 3) f32, region r its rows
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
    lib = _build.load_library()
    chunks = round_chunks(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    units, smem_points = anneal_units(n, lib.tsar_ransac_cluster())
    chunks = torch.as_tensor(np.array(chunks, np.int64), device=dev)
    units = torch.as_tensor(np.array(units, np.int32), device=dev)
    planes = torch.empty((R, HYPOTHESES, 4), dtype=torch.float32, device=dev)
    counts = torch.empty((R, HYPOTHESES), dtype=torch.int32, device=dev)
    state = torch.empty((R, 8), dtype=torch.int32, device=dev)
    plane = torch.empty((R, 4), dtype=torch.float32, device=dev)
    count = torch.empty(R, dtype=torch.int32, device=dev)
    thr = torch.empty(R, dtype=torch.float32, device=dev)
    code = lib.tsar_ransac_regions(
        points.data_ptr(), offsets.data_ptr(), idx.data_ptr(),
        deltas.data_ptr(), thr0.data_ptr(), total.data_ptr(),
        gain.data_ptr(), R, idx.shape[1], deltas.shape[1], float(thr_max),
        float(thr_step), float(ratio), float(eps), float(tiny),
        chunks.data_ptr(), chunks.shape[0], units.data_ptr(),
        units.shape[0], smem_points, planes.data_ptr(), counts.data_ptr(),
        state.data_ptr(), plane.data_ptr(), count.data_ptr(),
        thr.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "tsar_ransac_regions")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(R, max(n))] += 1
    return plane, count, thr
