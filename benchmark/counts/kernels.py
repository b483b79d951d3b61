"""Frozen operation and byte counts of the port's hand kernels, and their
least times on one NVIDIA H100 (SXM, 700 W): the larger of the bytes over
3.35 TB/s and the float operations over 67 TFLOP/s (the published HBM3
bandwidth and float32 rate outside the tensor cores).

A copy of ``tsar_mvs_tpu_torch/kernel_times.py``'s arithmetic
(`b1_bound`, B2's bytes in `time_b2_level`, `b4_flops`/`b4_bound`,
`b6_bytes`/`b6_bound`, `launch_plan`), kept here so that a change to the
program cannot move its own yardstick. Everything is counted from the
shapes that a configuration's frozen `plan` states (levels, iterations,
propagation banks, refine scales, sources, window offsets, the
scene-shared plane counts and the WMF passes' offsets), per reference
view. Where a kernel's traffic depends on the data, the count takes the
least that any input needs, so that a share of this time is a lower
bound and never reads above 100%:

- B1 leaves its volume reads out (which voxels a window touches depends
  on the planes; kernel_times counts each touched voxel once);
- B6's accepts count no taken position (kernel_times counts each taken
  position's writes).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

B1_FLOPS_PER_SAMPLE = 21
B1_FLOPS_PER_EPILOGUE = 15
B2_FLOPS_PER_VOXEL = 26
B4_FLOPS_PER_OFFSET = 4 + 1
B4_MEDIANS = 4
B4_BYTES_PER_PIXEL = 4 + 4 + 12 + 1 + 12 + 4 + 8 + 8
B6_FLOPS = {"prop_select": 30, "prop_accept": 11, "refine_propose": 70,
            "refine_accept": 1}


def least_seconds(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def level_grids(resolution, levels) -> list[tuple[int, int]]:
    """(H, W) of each pyramid level (each halving floors)."""
    W, H = resolution
    out = []
    for level in levels:
        h, w, f = H, W, 1
        while f < level:
            h, w, f = h // 2, w // 2, f * 2
        out.append((h, w))
    return out


def b1_launches(plan: dict, resolution) -> list[dict]:
    """B1's launches of one view in launch order: the coarsest level's
    dense random initialisation (C = 1), then per iteration and parity
    one propagation evaluation (C = banks) and one evaluation per refine
    scale (C = 1) on the packed half grid."""
    out = []
    for li, (H, W) in enumerate(level_grids(resolution, plan["levels"])):
        out += [{"px": H * W, "C": 1}] * plan["init"][li]
        half = ([{"px": H * (W // 2), "C": plan["banks"][li]}]
                + [{"px": H * (W // 2), "C": 1}] * plan["refine_scales"][li])
        out += half * (2 * plan["iterations"][li])
    return out


def b1_counts(px: int, C: int, O: int, V: int) -> tuple[int, int]:
    """(bytes, operations) of one B1 evaluation: weights and centred
    reference values (8 B an offset), four statistics (16 B), three plane
    scalars in and cost, ratio, view out (24 B a candidate) per pixel; 21
    operations a window sample, view and candidate and 15 an epilogue."""
    nbytes = px * (8 * O + 16 + 24 * C)
    flops = px * V * C * (B1_FLOPS_PER_SAMPLE * O + B1_FLOPS_PER_EPILOGUE)
    return nbytes, flops


def b1_least_seconds(plan: dict, resolution) -> tuple[float, int]:
    """(least seconds, launches) of one view's B1 evaluations."""
    O, V = plan["window_offsets"], plan["sources"]
    launches = b1_launches(plan, resolution)
    return sum(least_seconds(*b1_counts(x["px"], x["C"], O, V))
               for x in launches), len(launches)


def b2_counts(S: int, H: int, W: int) -> tuple[int, int]:
    """(bytes, operations) of one volume build: 2 B a voxel written plus
    the source (kernel_times' count), 26 operations a voxel."""
    return 2 * S * H * W + 2 * H * W + 48, B2_FLOPS_PER_VOXEL * S * H * W


def b2_least_seconds(plan: dict, resolution) -> tuple[float, int]:
    """(least seconds, launches) of one view's volume builds: one per
    source and level, at the scene-shared plane counts."""
    total, n = 0.0, 0
    for (H, W), planes in zip(level_grids(resolution, plan["levels"]),
                              plan["planes"]):
        for S in planes:
            total += least_seconds(*b2_counts(S, H, W))
            n += 1
    return total, n


def b4_flops(px: int, O: int) -> int:
    steps = max(1, (O - 1).bit_length())
    return px * (O * B4_FLOPS_PER_OFFSET + B4_MEDIANS * steps * O + O
                 + steps * (O + 1))


def b4_least_seconds(plan: dict, resolution) -> tuple[float, int]:
    """(least seconds, launches) of one view's WMF passes: one launch a
    pass over the full image, 53 B a pixel, b4_flops operations."""
    W, H = resolution
    total = sum(least_seconds(B4_BYTES_PER_PIXEL * H * W, b4_flops(H * W, O))
                for O in plan["wmf_offsets"])
    return total, len(plan["wmf_offsets"])


def b6_counts(kernel: str, H: int, W: int, banks: int) -> tuple[int, int]:
    """(bytes, operations) of one B6 launch on a level of H x W, packed
    half grid H x W/2, no taken position counted."""
    n = H * (W // 2)
    if kernel == "prop_select":
        nbytes = 20 * H * W + 29 * banks * n
    elif kernel == "prop_accept":
        nbytes = 21 * banks * n + 4 * n
    elif kernel == "refine_propose":
        nbytes = (16 + 16 + 28) * n
    else:
        nbytes = 8 * n
    per = banks if kernel.startswith("prop") else 1
    return nbytes, B6_FLOPS[kernel] * per * n


def b6_least_seconds(plan: dict, resolution) -> tuple[float, int]:
    """(least seconds, launches) of one view's half-passes: per iteration
    and parity a propagation half-pass (select, accept) and per refine
    scale a proposal and an accept."""
    total, n = 0.0, 0
    for li, (H, W) in enumerate(level_grids(resolution, plan["levels"])):
        halves = 2 * plan["iterations"][li]
        banks = plan["banks"][li]
        scales = plan["refine_scales"][li]
        for kernel, times in (("prop_select", halves),
                              ("prop_accept", halves),
                              ("refine_propose", halves * scales),
                              ("refine_accept", halves * scales)):
            total += times * least_seconds(*b6_counts(kernel, H, W, banks))
            n += times
    return total, n
