"""Frozen operation and byte counts of kernel B3 (``csrc/direct.cu``, the
direct sampler's multi-view cost), and its least time on one NVIDIA
H100 at the peaks of ``counts/kernels.py``.

A copy of ``tsar_mvs_tpu_torch/kernel_times.py``'s `b3_flops` with its
``B3_FLOPS_*`` constants, and of `b3_bound`'s bytes without
`source_bytes_touched`: which packed source pixels a window reads depends
on the planes, so the count leaves them out, and a share of this time is
a lower bound, as B1's is. The launches are B1's on the s-volume path
(`kernels.b1_launches`): the direct path evaluates the same candidates
at the same levels, one launch a block of up to 8 candidates, and no
evaluation of the plan has more.

The kernel's instance (`instance`) follows ``ops/cuda_direct.py``'s
`instance_for`: its template arguments are the candidate slots, the
channels, the aggregation registers and whether the window is the
default one.
"""

from __future__ import annotations

from benchmark.counts.kernels import b1_launches, least_seconds

# Float operations of B3's function, counted where each depends on its
# inputs: per (offset, candidate) the plane coordinate and its finiteness
# test; per (offset, view) the warp's offset term; per (offset, view,
# candidate) the projection, its reciprocal, the clamp, floor and
# fraction; per channel of it the interpolation, the centring and the
# moments; per (view, candidate) the epilogue; per (pixel, view) A p~.
B3_FLOPS_PER_OFFSET_CANDIDATE = 5
B3_FLOPS_PER_OFFSET_VIEW = 3
B3_FLOPS_PER_SAMPLE = 17
B3_FLOPS_PER_CHANNEL = 16
B3_FLOPS_PER_EPILOGUE = 15
B3_FLOPS_PER_PIXEL_VIEW = 12


def b3_flops(px: int, O: int, V: int, C: int, CH: int) -> int:
    """Float operations of one direct multi-view cost evaluation of C
    candidates on px pixels against V views in CH channels, O window
    offsets."""
    return px * (O * C * B3_FLOPS_PER_OFFSET_CANDIDATE
                 + O * V * B3_FLOPS_PER_OFFSET_VIEW
                 + O * V * C * (B3_FLOPS_PER_SAMPLE
                                + B3_FLOPS_PER_CHANNEL * CH)
                 + V * C * B3_FLOPS_PER_EPILOGUE
                 + V * B3_FLOPS_PER_PIXEL_VIEW)


def b3_counts(px: int, C: int, O: int, V: int, CH: int) -> tuple[int, int]:
    """(bytes, operations) of one B3 evaluation. Bytes, no source read
    counted: weights and centred reference channels (4 B each an offset),
    3 + CH statistics, three plane scalars in and cost, ratio, best view
    out a candidate."""
    nbytes = px * (4 * O * (1 + CH) + 4 * (3 + CH) + 24 * C)
    return nbytes, b3_flops(px, O, V, C, CH)


def b3_least_seconds(plan: dict, resolution) -> tuple[float, int]:
    """(least seconds, launches) of one view's B3 evaluations."""
    O, V, CH = plan["window_offsets"], plan["sources"], plan["channels"]
    launches = b1_launches(plan, resolution)
    return sum(least_seconds(*b3_counts(x["px"], x["C"], O, V, CH))
               for x in launches), len(launches)


def instance(plan: dict) -> tuple[int, int]:
    """(CH, NB) of the instance every launch of the plan takes: NB is 1
    for n_best 1; 4 for n_best up to 4, or up to 4 views; else 32."""
    n_best, V = plan["n_best"], plan["sources"]
    nb = 1 if n_best == 1 else (4 if n_best <= 4 or V <= 4 else 32)
    return plan["channels"], nb
