"""Times of the CUDA kernels at every shape the main path launches them
at, beside the least time the card could take, and PatchMatch's seconds
split into kernels B1, B2 and B6 and the torch code around them. Kernel B3
(the direct sampler) is timed at the shapes the direct path launches:
the same grids and candidate counts as B1's.

    python -m tsar_mvs_tpu_torch.kernel_times render <scene_dir>
    python -m tsar_mvs_tpu_torch.kernel_times time <scene_dir> [--json OUT]
    python -m tsar_mvs_tpu_torch.kernel_times b3 <scene_dir> [--json OUT]
    python -m tsar_mvs_tpu_torch.kernel_times b4 <scene_dir> [--json OUT]
        [--before <older checkout>/tsar_mvs_tpu_torch/ops/wmf.py]
    python -m tsar_mvs_tpu_torch.kernel_times b4-parts <scene_dir>
        [--json OUT]
    python -m tsar_mvs_tpu_torch.kernel_times b5 <scene_dir> [--json OUT]
        [--before <older checkout's root>]
    python -m tsar_mvs_tpu_torch.kernel_times b5-design <scene_dir>
        [--json OUT]
    python -m tsar_mvs_tpu_torch.kernel_times b5-parts <scene_dir>
        [--json OUT]
    python -m tsar_mvs_tpu_torch.kernel_times b6 <scene_dir> [--json OUT]
        [--before <older checkout's root>]

`render` writes the 1344x2048, 8-view synthetic scene (images, cameras,
pair.txt) and view 0's ground truth (`gt_view0.npz`) once (one spawned
process per view), so a scene on disk is reused. `time` needs a CUDA
device. `b3` times kernel B3 alone: every shape and variant of
`time_b3_level` at every level, then PatchMatch's split on the direct
sampler in grayscale, colour and n_best 3; it uses only the functions of
`ops/cuda_direct.py` that every version of the port has, so a copy of
this file in an older checkout times that checkout's kernel.
`b4` times kernel B4 (the weighted median plane) at each of the ten WMF
passes of view 0, on the inputs `process_view` gives them
(`recording_wmf_inputs`), beside its bound and its plain version. With
`--before` it also times an older checkout's plain PyTorch WMF, the
row-chunked `_median_plane_chunked` of its `ops/wmf.py`: only a checkout
from before B4 has that function (later ones run B4), so the option
serves only to compare against such a checkout. `b4-parts` times B4 at
two of those passes as built and with each of its parts taken out
(`B4_PARTS`): what each part costs. `b5` first splits the process's
first RANSAC into its parts (`first_ransac_split`), then times kernel B5
(the region RANSAC of a view) on the regions `process_view` gives it for
view 0 (`recording_ransac_inputs`), beside its bound, its ceiling, the
latency of its dependent chain (`chain_inputs`), its plain version and
its split into rounds and annealing, then on every refining view of the
scene with the view's region sizes, and the `ransac` stage
(`fit_region_planes`); with `--before` an older checkout's B5 kernel,
built from that checkout's own `csrc/` by its own `_build.py`, and its
`ransac` stage (`load_before`), each alternated with this one's in one
process (before, this, this, before). `b5-design` times B5 built with
each combination of the annealing's blocks a cluster, steps a pass
and threads a block (`B5_DESIGN`) on view 0's regions, its chain and the
"many" and "odd_steps" stress inputs; `b5-parts` times B5 there with
each part of its annealing pass taken out (`B5_PARTS`).
`b6` records the first propagation and refinement half-pass of every
level of view 0's pyramid, on the scene and on chip_smoke.py phase
8(e)'s 500x750 scene (whose levels 4 and 2 run dense), holds kernel B6
(the half-pass around the cost kernel) to its plain version on each and
on its stress input (`b6_stress`), times each B6 kernel there beside its
bound, its plain version and its launches in one pyramid, then splits
PatchMatch's seconds (`patchmatch_split`: wall, device busy, launches of
every kind); with `--before` an older checkout's PatchMatch
(`load_pm_before`: its models/patchmatch.py and ops/ncc.py) is split
too, alternated before, this, this, before in one process.
It measures through the functions the main path calls
(`svolume.multiview_cost_svolume`, `cuda_warp.build_svolume_view`,
`patchmatch.run_patchmatch_pyramid`). `chip_smoke.py` calls the same
functions on its own scene.

Shapes (levels (4, 2, 1) of a 1344x2048 view with 7 sources): kernel B1
on each level's packed grid with the propagation pass's candidate count
(8 on the coarsest level, 4 on the lifted ones) and the refinement pass's
(1), on a random plane field (what random initialisation evaluates) and
on a smooth one (the ground-truth planes with a refine-scale
perturbation: what propagation and refinement evaluate once the state
has converged), and on the coarsest level's dense grid (initialisation);
kernel B2 on each level's largest view volume; kernel B3 on B1's grids,
candidate counts and fields, on every level in grayscale with n_best 1
(the direct path of `ncc_impl="direct"`), with n_best 3 and in colour
(channels from `color_from_gray`). Kernel B1 has one inner
loop for the default 11x11 stride-2 window and a generic one for every
other window; `time_b1_windows` times both on the full-resolution smooth
field (9x9 and 13x13 beside the default) per window sample.

The bound of a shape is the larger of bytes / 3.35 TB/s (each input read
and each output written once; of the volume, the bytes this plane field
touches) and operations / 67 TFLOP/s (float32 outside the tensor cores),
the published peaks of an H100 SXM. 67 TFLOP/s counts a fused
multiply-add as two operations; B1, B3 and B4 round every step to
equal their plain versions to the bit, so they cannot fuse, and their
`ceiling_ms` counts the operations at half that rate.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

from tsar_mvs_tpu_torch import trace

H, W, VIEWS = 1344, 2048, 8
LEVELS = (4, 2, 1)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Float operations per window sample (plane coordinate 6, clamp and
# bracket 4, interpolation and centring 6, moments 5) and per candidate
# epilogue of kernel B1; per voxel of kernel B2 (warp 9, clamp and
# split 8, bilinear 9).
B1_FLOPS_PER_SAMPLE = 21
B1_FLOPS_PER_EPILOGUE = 15
B2_FLOPS_PER_VOXEL = 26
# Float operations of B3's function, counted where each depends on its
# inputs, whatever implements it: per (offset, candidate) the plane
# coordinate (2 multiplies, 2 adds) and its finiteness test; per (offset,
# view) the warp's A p~ plus the offset's term (3 adds); per (offset,
# view, candidate) the projection q = a - b s (3 multiplies, 3
# subtracts), the reciprocal of q.z and two multiplies, the clamp (4),
# floor and fraction (4); per channel of it the interpolation (9), the
# centring (1) and the moments (6); per (view, candidate) the epilogue;
# per (pixel, view) A p~ (6 multiplies, 6 adds).
B3_FLOPS_PER_OFFSET_CANDIDATE = 5
B3_FLOPS_PER_OFFSET_VIEW = 3
B3_FLOPS_PER_SAMPLE = 17
B3_FLOPS_PER_CHANNEL = 16
B3_FLOPS_PER_EPILOGUE = 15
B3_FLOPS_PER_PIXEL_VIEW = 12
# The earlier, view-wise count, kept beside it: 21 a sample (offset,
# view, candidate: the plane coordinate and the warp counted per view),
# 16 a channel, 15 an epilogue.
B3_FLOPS_PER_SAMPLE_VIEWWISE = 21
# Float operations of B4's function, whatever computes it, per pixel and
# offset: the weight (subtract, multiply, exp, multiply; exp counted as
# one) and its add to the total. Each of the four medians then needs
# about ceil(log2 O) fixed-order sums of O masked adds: the sums are
# monotone in the mask, so a search over the sorted distinct keys finds
# the median in that many (the plain version's radix descent takes 32,
# B4's two-level search 10; the key order's integer compares and sorts
# are not counted). The donor needs its base (O adds)
# and one sum of O masked adds and the add of the base per index bit.
# Bytes per pixel: gray, disp, the normal (f32) and reliable (bool) read,
# three medians and the donor disparity (f32), the donor index and the
# count (int64) written.
B4_FLOPS_PER_OFFSET = 4 + 1
B4_MEDIANS = 4
B4_BYTES_PER_PIXEL = 4 + 4 + 12 + 1 + 12 + 4 + 8 + 8
# Hypotheses a RANSAC round (models/ransac.py RANSAC_ROUND).
RANSAC_HYPOTHESES = 1000
# Windows (box_hsize, box_vsize; stride 2) of `time_b1_windows`: the
# default between two that take kernel B1's generic loop.
WINDOWS = ((9, 9), (11, 11), (13, 13))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn):
    """(fn(), device milliseconds of that one call) (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, repeats: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call over `repeats` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def device_times(fn) -> dict | None:
    """Device microseconds and launch counts of one call of `fn`, by
    kernel: {"b1": [us, n], "b2": [us, n], "b3": [us, n], "b4": [us, n],
    "b6": [us, n], "b7": [us, n], "other": [us, n] (every other kernel,
    copy and fill),
    "b1_each_us":
    B1's launches one by one in launch order} from torch.profiler, or None
    when the profiler reports no device activity (it sometimes drops a
    short trace: two attempts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = {"b1": [0.0, 0], "b2": [0.0, 0], "b3": [0.0, 0],
                  "b4": [0.0, 0], "b6": [0.0, 0], "b7": [0.0, 0],
                  "other": [0.0, 0]}
        b1_each = []
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            key = ("b1" if "svol_ncc" in e.name
                   else "b2" if "warp_build" in e.name
                   else "b3" if "direct_multiview" in e.name
                   else "b4" if "wmf_median" in e.name
                   else "b6" if "halfpass_" in e.name
                   else "b7" if "weak_" in e.name else "other")
            groups[key][0] += e.time_range.elapsed_us()
            groups[key][1] += 1
            if key == "b1":
                b1_each.append((e.time_range.start,
                                e.time_range.elapsed_us()))
        if sum(g[1] for g in groups.values()) > 0:
            groups["b1_each_us"] = [us for _, us in sorted(b1_each)]
            return groups
    return None


def render(scene_dir: Path) -> None:
    """The synthetic 2K scene and view 0's ground truth, on disk."""
    import numpy as np
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    scene = make_scene(height=H, width=W, num_views=VIEWS, seed=0,
                       workers=VIEWS)
    scene.export(scene_dir)
    np.savez_compressed(scene_dir / "gt_view0.npz",
                        depth=scene.depth[0].astype(np.float32),
                        normal_world=scene.normal_world[0]
                        .astype(np.float16))


def color_from_gray(gray):
    """Three unequal channels from a grayscale image (numpy or torch, the
    channel axis before the last two): the identity, a 0.8 gamma curve and
    0.6 g + 50, rounded to integers. Each is a pointwise monotone map, so
    every channel is consistent across views."""
    import numpy as np
    if isinstance(gray, np.ndarray):
        g = np.asarray(gray, np.float64)
        return np.stack([g, 255.0 * (g / 255.0) ** 0.8, 0.6 * g + 50.0],
                        axis=-3).round().astype(np.float32)
    import torch
    g = gray.to(torch.float64)
    return torch.stack([g, 255.0 * (g / 255.0) ** 0.8, 0.6 * g + 50.0],
                       dim=-3).round().to(torch.float32)


def level_inputs(scene, params, li: int, dev) -> dict:
    """What `run_patchmatch` builds on pyramid level `li` for view 0: the
    cameras, the level's parameters and images, the reference statistics
    and the s-volumes of all sources at the scene's plane counts."""
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    level = LEVELS[li]
    order, view_ids = pipeline.view_image_order(scene, 0, params.max_views)
    cams = geo.build_camera_set([scene.P[i] for i in order],
                                cam_scale=float(level) * params.cam_scale,
                                depth_min=scene.depth_min,
                                depth_max=scene.depth_max, device=dev)
    params_s = params.with_depth_range(scene.depth_min, scene.depth_max,
                                       float(cams.f))
    imgs = torch.as_tensor(scene.images[order], dtype=torch.float32,
                           device=dev)
    fac = 1
    while fac < level:
        imgs, fac = pm.downsample_2x(imgs), fac * 2
    counts = pipeline.scene_plane_counts(scene, params, LEVELS,
                                         len(view_ids))[li]
    idx = torch.as_tensor(list(view_ids), dtype=torch.int64, device=dev)
    s_lo, s_hi = sv.s_range_for_depths(params_s.depth_min,
                                       params_s.depth_max,
                                       params_s.svolume_margin)
    vol = sv.build_svolume(imgs[idx], cams.A[idx], cams.b[idx], s_lo, s_hi,
                           counts)
    stats = ncc.precompute_ref_stats(imgs[0], cams, params_s)
    return dict(level=level, cams=cams, params=params_s, imgs=imgs,
                counts=counts, ids=idx, s_lo=s_lo, s_hi=s_hi, vol=vol,
                stats=stats)


def random_field(lv: dict, C: int, gen):
    """C random planes per pixel: normals on the camera-facing
    hemisphere, depths uniform in the scene's range."""
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    cams, stats = lv["cams"], lv["stats"]
    Hs, Ws = lv["imgs"].shape[1:]
    dev = lv["imgs"].device
    n = geo.normalize(torch.randn((C, Hs, Ws, 3), generator=gen,
                                  device=dev))
    n = geo.hemisphere_flip(n, geo.view_vectors(cams, Hs, Ws))
    lo, hi = float(cams.depth_min) * 1.05, float(cams.depth_max) * 0.95
    depth = lo + (hi - lo) * torch.rand((C, Hs, Ws), generator=gen,
                                        device=dev)
    return n, geo.plane_d_from_depth(n, stats.rays, depth)


def smooth_field(lv: dict, gt: dict, C: int, gen):
    """C planes per pixel near the ground truth: the true depth and
    normal of view 0 at this level, each perturbed as the refinement pass
    perturbs at a middle scale (disparity +-0.5% of the range, normal
    +-1/16)."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    cams, stats, params = lv["cams"], lv["stats"], lv["params"]
    Hs, Ws = lv["imgs"].shape[1:]
    dev = lv["imgs"].device
    step = lv["level"]
    depth = np.asarray(gt["depth"], np.float32)[::step, ::step][:Hs, :Ws]
    depth = np.where(np.isfinite(depth), depth,
                     np.float32(np.median(depth[np.isfinite(depth)])))
    normal = np.asarray(gt["normal_world"],
                        np.float32)[::step, ::step][:Hs, :Ws]
    state = pm.state_from_prior(torch.as_tensor(depth, device=dev),
                                torch.as_tensor(normal, device=dev), cams)
    xx, yy = geo.pixel_grid(Hs, Ws, dev)
    depth0 = geo.depth_from_plane(cams, state.normal, state.d, xx, yy)
    disp = geo.disparity_depth(cams.f, cams.baseline, depth0)
    dz = params.max_disparity * 0.005
    disp = torch.clamp(
        disp + dz * (2.0 * torch.rand((C, Hs, Ws), generator=gen,
                                      device=dev) - 1.0),
        params.min_disparity, params.max_disparity)
    dn = (2.0 * torch.rand((C, Hs, Ws, 3), generator=gen, device=dev)
          - 1.0) / 16.0
    n = geo.hemisphere_flip(geo.normalize(state.normal + dn),
                            geo.view_vectors(cams, Hs, Ws))
    return n, geo.plane_d_from_depth(
        n, stats.rays, geo.disparity_depth(cams.f, cams.baseline, disp))


def volume_bytes_touched(lv: dict, s0, sx, sy, parity) -> int:
    """Bytes of the s-volumes that a cost evaluation of these plane
    scalars reads, each voxel counted once."""
    import torch
    from tsar_mvs_tpu_torch.ops import ncc
    params, vol = lv["params"], lv["vol"]
    Hc, Wc = s0.shape[-2:]
    dev = s0.device
    yy = torch.arange(Hc, device=dev)[:, None]
    xx = torch.arange(Wc, device=dev)[None, :].expand(Hc, Wc)
    if parity is not None:
        xx = 2 * xx + (parity + yy) % 2
    total = 0
    for v, data in enumerate(vol.data):
        S, Hv, Wv = data.shape
        seen = torch.zeros(S * Hv * Wv, dtype=torch.bool, device=dev)
        for (i, j) in ncc.window_offsets(params):
            t = (s0 + float(i) * sx + float(j) * sy - vol.s_lo) \
                * vol.inv_ds[v]
            finite = torch.isfinite(t)
            t = torch.clamp(torch.where(finite, t, 0.0), 0.0, float(S - 1))
            k0 = torch.floor(torch.clamp(t, max=float(S - 2))).to(
                torch.int64)
            pix = (torch.clamp(yy + j, 0, Hv - 1) * Wv
                   + torch.clamp(xx + i, 0, Wv - 1))
            idx = (k0 * (Hv * Wv) + pix)[finite]
            seen[idx] = True
            seen[idx + Hv * Wv] = True
        total += 2 * int(seen.sum())
        del seen
    return total


def b1_bound(lv: dict, s0, sx, sy, parity) -> dict:
    """Least milliseconds for one multi-view cost evaluation."""
    from tsar_mvs_tpu_torch.ops import ncc
    C = s0.shape[0]
    Hc, Wc = s0.shape[-2:]
    O = len(ncc.window_offsets(lv["params"]))
    V = len(lv["vol"].data)
    px = Hc * Wc
    vol_bytes = volume_bytes_touched(lv, s0, sx, sy, parity)
    # weights and centred reference, four statistics, three plane
    # scalars in and cost, ratio, best view out per candidate.
    nbytes = px * (8 * O + 16 + 24 * C) + vol_bytes
    flops = px * V * C * (B1_FLOPS_PER_SAMPLE * O + B1_FLOPS_PER_EPILOGUE)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "volume_bytes": vol_bytes, "flops": flops,
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main_path_fields(lv: dict, gt: dict):
    """(label, C, parity, normal, d) for every cost-evaluation shape of
    this level (B1's on the s-volume path, B3's on the direct one)."""
    import torch
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    gen = torch.Generator(device=lv["imgs"].device).manual_seed(7)
    coarsest = lv["level"] == LEVELS[0]
    for C in ((8, 1) if coarsest else (4, 1)):
        for label, make in (("smooth", smooth_field),
                            ("random", random_field)):
            n, d = (make(lv, gt, C, gen) if make is smooth_field
                    else make(lv, C, gen))
            yield (label, C, 0, cb.parity_compress_vec(n, 0),
                   cb.parity_compress(d, 0))
    if coarsest:
        n, d = random_field(lv, 1, gen)
        yield "random", 1, None, n[0], d[0]


def max_abs_diff(a, b) -> float:
    """Largest |a - b|, where a NaN on both sides agrees (a ratio best /
    second is 0 / 0 where both costs are 0, in the kernels as in their
    plain versions and the JAX package) and a NaN on one side is inf."""
    import torch
    d = torch.nan_to_num((a - b).abs(), nan=float("inf"))
    return float(torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d).max())


def agreement(mk, mp) -> dict:
    """Largest differences of two MultiviewCost results of one shape."""
    return {"max_abs_err": max_abs_diff(mk.cost, mp.cost),
            "ratio_max_abs_err": max_abs_diff(mk.ratio, mp.ratio),
            # A tie (ratio 1) may name either view.
            "best_view_mismatches": int(
                ((mk.best_view != mp.best_view) & (mp.ratio != 1.0)).sum())}


def b2_agreement(vol, plain) -> dict:
    """chip_smoke.py phase 3's bounds on a B2 volume against its plain
    version, counted a plane block at a time (no sort of the whole
    volume): median |delta| 0 (at most half the voxels differ), q99.9 <= 1
    (at most 0.1% differ by more than 1 intensity level) and max <= 2."""
    nonzero = above_1 = 0
    worst = 0.0
    for k in range(0, vol.shape[0], 16):
        d = (vol[k:k + 16].float() - plain[k:k + 16].float()).abs()
        nonzero += int((d > 0).sum())
        above_1 += int((d > 1.0).sum())
        worst = max(worst, float(d.max()))
    n = vol.numel()
    r = {"planes": int(vol.shape[0]), "frac_nonzero": nonzero / n,
         "frac_gt_1": above_1 / n, "max": worst}
    r["pass"] = (r["frac_nonzero"] < 0.5 and r["frac_gt_1"] <= 1e-3
                 and worst <= 2.0)
    return r


def time_b1_level(lv: dict, gt: dict) -> list[dict]:
    """Every B1 shape of one level: evaluation ms (CUDA events around
    `multiview_cost_svolume`), the kernel's own device ms and launches
    inside it (profiler), the plain version's ms and the bound."""
    import torch
    from tsar_mvs_tpu_torch.ops import cuda_ncc, ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    vol = lv["vol"]
    stats_by = {None: lv["stats"], 0: ncc.compress_stats(lv["stats"], 0)}
    out = []
    for label, C, parity, n, d in main_path_fields(lv, gt):
        st = stats_by[parity]

        def evaluate():
            return sv.multiview_cost_svolume(vol, lv["ids"], n, d, st,
                                             lv["params"], parity)

        s0, sx, sy = sv.plane_scalars(n, d, st)
        s0, sx, sy = (a.reshape(-1, *a.shape[-2:]) for a in (s0, sx, sy))
        res = {"level": lv["level"], "grid": list(s0.shape[-2:]), "C": C,
               "parity": parity, "field": label,
               "planes": list(lv["counts"]),
               "ms": time_ms(evaluate, 10, warmup=2)}
        dt = device_times(evaluate)
        res["kernel_ms"] = None if dt is None else dt["b1"][0] / 1e3
        res["kernel_launches"] = None if dt is None else dt["b1"][1]
        res["other_kernels_ms"] = None if dt is None else dt["other"][0] / 1e3

        def plain_eval():
            return cuda_ncc.multiview_cost_plain(
                vol.data, vol.s_lo, vol.inv_ds, lv["ids"], s0, sx, sy, st,
                lv["params"], parity)

        res["plain_ms"] = time_ms(plain_eval, 1, warmup=0)
        res.update(agreement(evaluate(), plain_eval()))
        res.update(b1_bound(lv, s0, sx, sy, parity))
        res["library_ms"] = None
        out.append(res)
        print(f"B1 shape: {json.dumps(res)}", flush=True)
    return out


def direct_inputs(lv: dict, color: bool):
    """Kernel B3's views (the level's sources, packed) and the reference
    statistics per parity, grayscale or in colour (color_from_gray)."""
    from tsar_mvs_tpu_torch.ops import cuda_direct, ncc
    from tsar_mvs_tpu_torch.ops import ncc_color as nc
    imgs, ids, cams = lv["imgs"], lv["ids"], lv["cams"]
    if color:
        imgs = color_from_gray(imgs)
        stats = nc.precompute_ref_stats_color(imgs[0], cams, lv["params"])
        by = {None: stats, 0: nc.compress_stats_color(stats, 0)}
    else:
        by = {None: lv["stats"], 0: ncc.compress_stats(lv["stats"], 0)}
    return cuda_direct.make_views(imgs[ids], cams.A[ids], cams.b[ids],
                                  ids), by


def source_bytes_touched(lv: dict, views, s0, sx, sy, parity) -> int:
    """Bytes of the packed sources that a direct cost evaluation of these
    plane scalars reads, each packed pixel (8 bytes a channel) counted
    once per view."""
    import torch
    from tsar_mvs_tpu_torch.ops import ncc
    Hs, Ws = lv["imgs"].shape[-2:]
    Hc, Wc = s0.shape[-2:]
    dev = s0.device
    yy = torch.arange(Hc, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(Wc, device=dev)[None, :].expand(Hc, Wc)
    if parity is not None:
        xx = 2 * xx + (parity + yy.to(torch.int64)) % 2
    xx = xx.to(torch.float32)
    total = 0
    for v in range(len(views.packed)):
        A, b = views.A[v], views.b[v]
        seen = torch.zeros(Hs * Ws, dtype=torch.bool, device=dev)
        for (i, j) in ncc.window_offsets(lv["params"]):
            s = s0 + float(i) * sx + float(j) * sy
            q = [A[r, 0] * (xx + i) + A[r, 1] * (yy + j) + A[r, 2] - b[r] * s
                 for r in range(3)]
            u = torch.clamp(torch.nan_to_num(q[0] / q[2], nan=0.0), 0,
                            Ws - 1).floor().to(torch.int64)
            w = torch.clamp(torch.nan_to_num(q[1] / q[2], nan=0.0), 0,
                            Hs - 1).floor().to(torch.int64)
            seen[(w * Ws + u)[torch.isfinite(s)]] = True
        total += 8 * views.channels * int(seen.sum())
        del seen
    return total


def b3_flops(px: int, O: int, V: int, C: int, CH: int) -> int:
    """Float operations of one direct multi-view cost evaluation of C
    candidates on px pixels (B3_FLOPS_* above)."""
    return px * (O * C * B3_FLOPS_PER_OFFSET_CANDIDATE
                 + O * V * B3_FLOPS_PER_OFFSET_VIEW
                 + O * V * C * (B3_FLOPS_PER_SAMPLE
                                + B3_FLOPS_PER_CHANNEL * CH)
                 + V * C * B3_FLOPS_PER_EPILOGUE
                 + V * B3_FLOPS_PER_PIXEL_VIEW)


def b3_bound(lv: dict, views, s0, sx, sy, parity) -> dict:
    """Least milliseconds for one direct multi-view cost evaluation, and
    the least a kernel that rounds every step can take (`ceiling_ms`: the
    operations at half the peak, which counts an FMA as two)."""
    from tsar_mvs_tpu_torch.ops import ncc
    C = s0.shape[0]
    Hc, Wc = s0.shape[-2:]
    O = len(ncc.window_offsets(lv["params"]))
    V, CH = len(views.packed), views.channels
    px = Hc * Wc
    src_bytes = source_bytes_touched(lv, views, s0, sx, sy, parity)
    # weights and centred reference channels, 3 + CH statistics, three
    # plane scalars in and cost, ratio, best view out per candidate.
    nbytes = px * (4 * O * (1 + CH) + 4 * (3 + CH) + 24 * C) + src_bytes
    flops = b3_flops(px, O, V, C, CH)
    flops_viewwise = px * V * C * (O * (B3_FLOPS_PER_SAMPLE_VIEWWISE
                                        + B3_FLOPS_PER_CHANNEL * CH)
                                   + B3_FLOPS_PER_EPILOGUE)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "source_bytes": src_bytes, "flops": flops,
            "flops_viewwise": flops_viewwise, "bytes_ms": t_bytes,
            "operations_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ceiling_ms": max(t_bytes, 2.0 * t_ops)}


# (n_best, colour) variants of kernel B3 timed on every level: the direct
# path of ncc_impl="direct", n_best 3 and -color_processing each launch
# it at every level.
B3_VARIANTS = ((1, False), (3, False), (1, True))


def time_b3_level(lv: dict, gt: dict) -> list[dict]:
    """Every B3 shape of one level (main_path_fields), per variant:
    evaluation ms (CUDA events around plane_scalars and
    `cuda_direct.multiview_cost_direct`), the kernel's own device ms and
    launches (profiler), the plain version's ms, the agreement, the bound
    and the rounding ceiling. No PyTorch call computes the windowed NCC
    (`grid_sample` does only the bilinear fetch), so library_ms is null."""
    import dataclasses
    from tsar_mvs_tpu_torch.ops import cuda_direct, ncc
    fields = list(main_path_fields(lv, gt))
    out = []
    for n_best, color in B3_VARIANTS:
        params = dataclasses.replace(lv["params"], n_best=n_best)
        views, stats_by = direct_inputs(lv, color)
        for label, C, parity, n, d in fields:
            st = stats_by[parity]

            def evaluate():
                return cuda_direct.multiview_cost_direct(
                    views, *ncc.plane_scalars(n, d, st), st, params, parity)

            s0, sx, sy = (a.reshape(-1, *a.shape[-2:])
                          for a in ncc.plane_scalars(n, d, st))
            res = {"level": lv["level"], "grid": list(s0.shape[-2:]),
                   "C": C, "parity": parity, "field": label,
                   "n_best": n_best, "channels": views.channels,
                   "ms": time_ms(evaluate, 10, warmup=2)}
            dt = device_times(evaluate)
            res["kernel_ms"] = None if dt is None else dt["b3"][0] / 1e3
            res["kernel_launches"] = None if dt is None else dt["b3"][1]

            plain, res["plain_ms"] = timed(
                lambda: cuda_direct.multiview_cost_direct_plain(
                    views, s0, sx, sy, st, params, parity))
            res.update(agreement(evaluate(), plain))
            del plain
            res.update(b3_bound(lv, views, s0, sx, sy, parity))
            res["library_ms"] = None
            out.append(res)
            print(f"B3 shape: {json.dumps(res)}", flush=True)
        del views, stats_by
    return out


def time_b1_windows(lv: dict, gt: dict) -> list[dict]:
    """Kernel B1 on this level's packed grid under each window of
    WINDOWS, smooth field, C = 1 and 4: evaluation ms, picoseconds per
    window sample (offset, view, candidate and pixel) and the agreement
    with the plain version. Only the default window takes the unrolled
    loop."""
    import dataclasses
    import torch
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    from tsar_mvs_tpu_torch.ops import cuda_ncc, ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    vol = lv["vol"]
    gen = torch.Generator(device=lv["imgs"].device).manual_seed(7)
    fields = {}
    for C in (1, 4):
        n, d = smooth_field(lv, gt, C, gen)
        fields[C] = (cb.parity_compress_vec(n, 0), cb.parity_compress(d, 0))
    out = []
    for box in WINDOWS:
        params = dataclasses.replace(lv["params"], box_hsize=box[0],
                                     box_vsize=box[1])
        st = ncc.compress_stats(
            ncc.precompute_ref_stats(lv["imgs"][0], lv["cams"], params), 0)
        O = len(ncc.window_offsets(params))
        for C, (n, d) in fields.items():
            def evaluate():
                return sv.multiview_cost_svolume(vol, lv["ids"], n, d, st,
                                                 params, 0)

            ms = time_ms(evaluate, 10, warmup=2)
            samples = O * len(vol.data) * d.numel()
            plain = cuda_ncc.multiview_cost_plain(
                vol.data, vol.s_lo, vol.inv_ds, lv["ids"],
                *sv.plane_scalars(n, d, st), st, params, 0)
            res = {"level": lv["level"], "window": list(box), "offsets": O,
                   "C": C, "ms": ms, "ps_per_sample": ms * 1e9 / samples,
                   **agreement(evaluate(), plain)}
            del plain
            out.append(res)
            print(f"B1 window: {json.dumps(res)}", flush=True)
        del st
    return out


def time_b2_level(lv: dict) -> dict:
    """B2 on the level's largest view volume: kernel, plain version,
    bound, and `grid_sample` on precomputed coordinates as the library
    call (float32 in and out; it leaves out the coordinate arithmetic and
    the rounding to bf16)."""
    import torch
    from tsar_mvs_tpu_torch.ops import cuda_warp
    counts = lv["counts"]
    slot = max(range(len(counts)), key=lambda k: counts[k])
    S = int(counts[slot])
    ds = (lv["s_hi"] - lv["s_lo"]) / (S - 1)
    v = int(lv["ids"][slot])
    src, A, b = lv["imgs"][v], lv["cams"].A[v], lv["cams"].b[v]
    Hs, Ws = src.shape

    def kernel():
        return cuda_warp.build_svolume_view(src, A, b, lv["s_lo"], ds, S)

    def plain_build():
        return cuda_warp.build_svolume_view_plain(src, A, b, lv["s_lo"], ds,
                                                  S)

    res = {"level": lv["level"], "grid": [Hs, Ws], "planes": S,
           "ms": time_ms(kernel, 5), "plain_ms": time_ms(plain_build, 1)}
    res["max_abs_err"] = float(
        (kernel().float() - plain_build().float()).abs().max())

    dev = src.device
    xx = torch.arange(Ws, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(Hs, dtype=torch.float32, device=dev)[None, :, None]
    s = (lv["s_lo"] + ds * torch.arange(S, dtype=torch.float32,
                                        device=dev))[:, None, None]
    u = [A[r, 0] * xx + A[r, 1] * yy + A[r, 2] for r in range(3)]
    inv_w = 1.0 / (u[2] - b[2] * s)
    grid = torch.stack([(u[0] - b[0] * s) * inv_w * (2.0 / (Ws - 1)) - 1.0,
                        (u[1] - b[1] * s) * inv_w * (2.0 / (Hs - 1)) - 1.0],
                       dim=-1).reshape(1, S * Hs, Ws, 2)
    del inv_w, u
    img = src.to(torch.bfloat16).float()[None, None]

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    res["library_ms"] = time_ms(library, 3)
    del grid
    nbytes = 2 * S * Hs * Ws + 2 * Hs * Ws + 48
    flops = B2_FLOPS_PER_VOXEL * S * Hs * Ws
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    res.update({"bytes": nbytes, "flops": flops, "bytes_ms": t_bytes,
                "operations_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    print(f"B2 shape: {json.dumps(res)}", flush=True)
    return res


def launch_plan(scene, params, levels=LEVELS) -> list[dict]:
    """Cost evaluations and volume builds of the main path per level of
    `levels` (process_view's are pipeline.pyramid_levels_for the image
    height), from the schedule `run_patchmatch_pyramid` follows: per
    iteration and parity one propagation evaluation (C = banks) and one
    refinement evaluation per refine scale (C = 1); one dense evaluation
    for the random initialisation of the coarsest level; one build per
    source."""
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    order, view_ids = pipeline.view_image_order(scene, 0, params.max_views)
    iters = pm.iteration_schedule(params, len(levels))
    plan = []
    for li, level in enumerate(levels):
        cams = geo.build_camera_set([scene.P[i] for i in order],
                                    cam_scale=float(level) * params.cam_scale,
                                    depth_min=scene.depth_min,
                                    depth_max=scene.depth_max, device="cpu")
        params_s = pm.level_params(params, li, float(cams.f),
                                   scene.depth_min, scene.depth_max)
        scales = len(pm.refine_schedule(params_s))
        plan.append({"level": level, "banks": pm.prop_bank_count(params_s),
                     "iterations": iters[li], "scales": scales,
                     "propagation": 2 * iters[li],
                     "refinement": 2 * iters[li] * scales,
                     "init": 1 if li == 0 else 0,
                     "builds": len(view_ids)})
    return plan


def launch_sequence(plan: list[dict]) -> list[tuple[int, str]]:
    """(level, kind) of every cost evaluation of the main path in launch
    order; kind is "init", "propagation", "refine_widest" (each pass's
    first, widest refine scale) or "refine"."""
    seq = []
    for p in plan:
        seq += [(p["level"], "init")] * p["init"]
        half_pass = ([(p["level"], "propagation")]
                     + [(p["level"], "refine_widest")]
                     + [(p["level"], "refine")] * (p["scales"] - 1))
        seq += half_pass * (2 * p["iterations"])
    return seq


def b1_seconds_by_kind(plan: list[dict], each_us: list[float]) -> dict:
    """Kernel B1's device seconds on the main path, summed by level and
    kind of evaluation, from its launches' times in launch order."""
    seq = launch_sequence(plan)
    if len(seq) != len(each_us):
        raise ValueError(f"{len(each_us)} B1 launches for a plan of "
                         f"{len(seq)} evaluations")
    out: dict[str, list] = {}
    for (level, kind), us in zip(seq, each_us):
        acc = out.setdefault(f"level {level} {kind}", [0.0, 0])
        acc[0] += us / 1e6
        acc[1] += 1
    return out


def pyramid_runner(scene, params, dev, pm=None):
    """A function that runs view 0's `run_patchmatch_pyramid` as
    `process_view` does, from a generator seeded 0; with
    `color_processing` on the views' `color_from_gray` channels (the
    values chip_smoke.py's colour export holds). `pm`: the patchmatch
    module to run (default this package's; `load_pm_before` gives an
    older checkout's)."""
    import torch
    from tsar_mvs_tpu_torch import pipeline
    if pm is None:
        from tsar_mvs_tpu_torch.models import patchmatch as pm
    order, view_ids = pipeline.view_image_order(scene, 0, params.max_views)
    imgs = torch.as_tensor(scene.images[order], dtype=torch.float32,
                           device=dev)
    imgs_color = color_from_gray(imgs) if params.color_processing else None
    planes = pipeline.scene_plane_counts(scene, params, LEVELS,
                                         len(view_ids))

    def run():
        gen = torch.Generator(device=dev).manual_seed(0)
        return pm.run_patchmatch_pyramid(
            gen, imgs, view_ids, [scene.P[i] for i in order], params,
            levels=LEVELS,
            iterations_per_level=pm.iteration_schedule(params, len(LEVELS)),
            depth_min=scene.depth_min, depth_max=scene.depth_max,
            svol_planes_per_level=planes, imgs_color=imgs_color)
    return run


def patchmatch_split(scene, params, dev, pm=None, label: str = "") -> dict:
    """Seconds of one `run_patchmatch_pyramid` of view 0 (host clock,
    synchronised, after a warm-up run) and, from a profiled third run,
    the device seconds inside it of kernels B1, B2, B3 and B6 and of every
    other kernel and copy, with their launch counts, the device's busy
    seconds and the launches of every kind ("launches": kernels, copies
    and fills). `pm` as in pyramid_runner."""
    import torch
    run = pyramid_runner(scene, params, dev, pm)
    run()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    dt = device_times(run)
    res = {"seconds": seconds}
    if dt is None:
        res["device"] = None
    else:
        res["b1_each_us"] = dt.pop("b1_each_us")
        res["device"] = {k: {"seconds": us / 1e6, "launches": n}
                         for k, (us, n) in dt.items()}
        busy = sum(us for us, _ in dt.values()) / 1e6
        res["device_busy_s"] = busy
        res["launches"] = sum(n for _, n in dt.values())
        res["rest_s"] = min(seconds) - sum(dt[k][0] for k in
                                           ("b1", "b2", "b3", "b6")) / 1e6
    print(f"patchmatch split{label}: "
          + json.dumps({k: v for k, v in res.items() if k != "b1_each_us"}),
          flush=True)
    return res


# The direct paths whose PatchMatch `direct_splits` times: AlgorithmParams
# overrides of each.
DIRECT_PATHS = {"gray": {"ncc_impl": "direct"},
                "colour": {"color_processing": True},
                "n_best 3": {"n_best": 3}}


def direct_splits(scene, params, dev) -> dict:
    """patchmatch_split of view 0 on each direct path (kernel B3)."""
    import dataclasses
    import torch
    out = {}
    for name, over in DIRECT_PATHS.items():
        torch.cuda.empty_cache()
        print(f"direct path: {name}", flush=True)
        res = patchmatch_split(scene, dataclasses.replace(params, **over),
                               dev)
        res.pop("b1_each_us", None)
        out[name] = res
    return out


def time_b3_all(scene, gt: dict, dev) -> dict:
    """Every B3 shape and variant, level by level, then the direct paths'
    PatchMatch splits, with the card line and, where the port reports
    them, the kernel instances' registers and local bytes."""
    import torch
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.ops import cuda_direct
    params = pipeline.default_params_for_scene(scene)
    b3 = []
    for li in range(len(LEVELS)):
        lv = level_inputs(scene, params, li, dev)
        b3.extend(time_b3_level(lv, gt))
        del lv
        torch.cuda.empty_cache()
    res = {"b3": b3, "direct_paths": direct_splits(scene, params, dev)}
    if hasattr(cuda_direct, "kernel_attributes"):
        res["instances"] = cuda_direct.kernel_attributes()
        res["instances_launched"] = sorted(
            list(k) for k in trace.by_key("launches_by_instance.b3"))
    return res


def b4_flops(px: int, O: int) -> int:
    """Float operations of one B4 pass over `px` pixels with O offsets:
    per pixel 5 O for the weights and their total, 4 ceil(log2 O) O for
    the medians' searches, O for the donor's base and ceil(log2 O) (O + 1)
    for its index (4,968 at O = 121)."""
    steps = max(1, (O - 1).bit_length())
    return px * (O * B4_FLOPS_PER_OFFSET + B4_MEDIANS * steps * O + O
                 + steps * (O + 1))


def b4_bound(H: int, W: int, O: int) -> dict:
    """B4's bound at an H x W pass with O offsets: the larger of its bytes
    over 3.35 TB/s and its operations (b4_flops) over 67 TFLOP/s; and its
    ceiling, the operations at half that rate (`ceiling_ms`): every
    operation counted is a single rounded add or multiply, which the
    67 TFLOP/s peak counts once in a fused multiply-add's two."""
    nbytes = B4_BYTES_PER_PIXEL * H * W
    flops = b4_flops(H * W, O)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": t_bytes,
            "operations_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ceiling_ms": max(t_bytes, 2.0 * t_ops)}


@contextlib.contextmanager
def recording_wmf_inputs(calls: list):
    """While open, every `wmf.median_plane` call (each WMF pass) appends
    its inputs to `calls` (tensors cloned) and then runs as before."""
    from tsar_mvs_tpu_torch.ops import wmf
    inner = wmf.median_plane

    def record(gray, disp, normal, reliable, offsets, spatial_div,
               sigma_spatial, sigma_color, radius, chunk_rows=256):
        calls.append({"gray": gray.clone(), "disp": disp.clone(),
                      "normal": normal.clone(),
                      "reliable": reliable.clone(), "offsets": offsets,
                      "spatial_div": spatial_div,
                      "sigma_spatial": sigma_spatial,
                      "sigma_color": sigma_color, "radius": radius})
        return inner(gray, disp, normal, reliable, offsets, spatial_div,
                     sigma_spatial, sigma_color, radius, chunk_rows)

    wmf.median_plane = record
    try:
        yield calls
    finally:
        wmf.median_plane = inner


def b4_args(call: dict) -> tuple:
    """`wmf.median_plane`'s arguments (without chunk_rows) of a call."""
    return (call["gray"], call["disp"], call["normal"], call["reliable"],
            call["offsets"], call["spatial_div"], call["sigma_spatial"],
            call["sigma_color"], call["radius"])


def pass_names(params) -> list[str]:
    """"mark i" and "fill i" of a view's WMF passes, in their order."""
    return ([f"mark {i}" for i in range(params.wmf_iters)]
            + [f"fill {i}" for i in range(params.wmf_final_iters)])


def b4_agreement(mk, mp) -> dict:
    """Largest |delta| of every output of two median planes, on their
    int32 views (int64 outputs as pairs of int32; a NaN's bits count), and
    their largest as "max_abs_err"."""
    import torch
    out = {}
    for name, a, b in zip(mp._fields, mk, mp):
        ai = a.contiguous().view(torch.int32).to(torch.int64)
        bi = b.contiguous().view(torch.int32).to(torch.int64)
        out[name] = int((ai - bi).abs().max())
    out["max_abs_err"] = max(out.values())
    return out


def wmf_crop(call: dict, rows: int = 256, cols: int = 384) -> dict:
    """A pass's inputs cut to their top-left rows x cols (two sides on the
    image border) with: an unreliable 208 x 208 block in the corner, so
    the pixels near (40, 40) have no valid sample at any pass's radius
    (up to 160); disparities rounded to 1/4 and normals to 1/8 in the
    bottom-right quarter (tied keys); and, spread over the rest, +inf,
    -inf and NaN disparities and -0.0 normal components."""
    import torch
    c = dict(call)
    g, d, n, r = (call[k][:rows, :cols].clone()
                  for k in ("gray", "disp", "normal", "reliable"))
    r[:208, :208] = False
    q = (slice(rows // 2, None), slice(cols // 2, None))
    d[q] = torch.round(d[q] * 4.0) / 4.0
    n[q] = torch.round(n[q] * 8.0) / 8.0
    flat = d.view(-1)
    for k, v in enumerate((float("inf"), float("-inf"), float("nan"))):
        flat[k::97] = v
    n.view(-1)[3::89] = -0.0
    c.update(gray=g.contiguous(), disp=d, normal=n, reliable=r)
    return c


WMF_CASES = ("slanted", "equal", "one_valid", "cross_zero", "nan_heavy")


def wmf_cases(call: dict, rows: int, cols: int) -> dict:
    """Inputs that stress B4's search, each a pass's inputs `call` cut to
    its top-left rows x cols with some fields replaced (no random draws,
    so every device builds the same pattern from the same call):
    "slanted", a plane rising fastest in x, so every pixel's keys are
    sorted along the offset order (dx major), normals likewise; "equal",
    one disparity and one normal everywhere (all 121 keys tie); "one_valid",
    a single reliable pixel, so its neighbours see one valid sample or
    none; "cross_zero", disparities and normal components of both signs
    around zero with exact +-0.0 (no common prefix of the ordered keys);
    "nan_heavy", the NaN whose bits are 0x7FFFFFFF (the largest ordered
    key) as the disparity of 70% of the pixels, so it carries most of the
    weight."""
    import torch
    g, d, n, r = (call[k][:rows, :cols].clone()
                  for k in ("gray", "disp", "normal", "reliable"))
    dev = d.device
    yy, xx = torch.meshgrid(torch.arange(rows, dtype=torch.float32,
                                         device=dev),
                            torch.arange(cols, dtype=torch.float32,
                                         device=dev), indexing="ij")
    base = {**call, "gray": g.contiguous()}

    def case(disp, normal, reliable):
        return {**base, "disp": disp.contiguous(),
                "normal": normal.contiguous(),
                "reliable": reliable.contiguous()}

    ones = torch.ones_like(xx)
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32,
                       device=dev).view(torch.float32)
    cross = torch.stack([0.1 * torch.sin(0.37 * xx + 0.11 * yy),
                         0.1 * torch.cos(0.23 * xx - 0.29 * yy),
                         0.05 * torch.sin(0.13 * xx + 0.41 * yy)], dim=-1)
    cross.view(-1)[::7] = 0.0
    cross.view(-1)[3::11] = -0.0
    cross_disp = 0.5 * torch.sin(0.31 * xx - 0.19 * yy)
    cross_disp.view(-1)[::13] = -0.0
    lone = torch.zeros_like(r)
    lone[rows // 2, cols // 2] = True
    return {
        "slanted": case(20.0 + 0.25 * xx + 0.001 * yy,
                        torch.stack([0.1 + 1e-3 * xx + 1e-6 * yy,
                                     0.2 + 1e-3 * xx + 1e-6 * yy,
                                     -1.0 + 1e-4 * xx + 1e-7 * yy], -1),
                        torch.ones_like(r)),
        "equal": case(30.0 * ones,
                      torch.stack([0.0 * ones, 0.0 * ones, -ones], -1), r),
        "one_valid": case(d, n, lone),
        "cross_zero": case(cross_disp, cross, r),
        "nan_heavy": case(torch.where((xx + 2.0 * yy) % 10.0 < 7.0, nan, d),
                          n, torch.ones_like(r)),
    }


def wmf_truth_call(scene_gt, cams, params, gen, kind: str = "mark",
                   iteration: int = 0) -> dict:
    """One WMF pass's inputs for view 0 of a utils.synthetic scene, made
    from its ground truth on `gen`'s device: the view's gray image, the
    disparity of the true depth with 1% noise and 10% of the pixels
    redrawn within +-30%, the true normals (view frame) with noise, 70% of
    the pixels reliable; pass `kind` `iteration` of `params`."""
    import torch
    import torch.nn.functional as F
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.ops import wmf
    dev = gen.device
    gt = torch.as_tensor(scene_gt.depth[0], device=dev)
    gt = torch.where(torch.isfinite(gt), gt, float(scene_gt.depth_max))
    H, W = gt.shape

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    depth = gt * (1.0 + 0.01 * torch.randn((H, W), generator=gen,
                                            device=dev))
    depth = torch.where(uniform(H, W) < 0.1,
                        gt * (0.7 + 0.6 * uniform(H, W)), depth)
    n = torch.as_tensor(scene_gt.normal_cam[0], dtype=torch.float32,
                        device=dev)
    n = F.normalize(n + 0.05 * torch.randn((H, W, 3), generator=gen,
                                           device=dev), dim=-1)
    radius, gap, div = wmf.pass_schedule(kind, iteration)
    return {"gray": torch.as_tensor(scene_gt.images[0], dtype=torch.float32,
                                    device=dev),
            "disp": geo.disparity_depth(cams.f, cams.baseline,
                                        depth).to(torch.float32),
            "normal": n.contiguous(), "reliable": uniform(H, W) < 0.7,
            "offsets": wmf.sample_offsets(radius, gap), "spatial_div": div,
            "sigma_spatial": params.wmf_sigma_spatial,
            "sigma_color": params.wmf_sigma_color, "radius": radius}


def time_b4(calls: list, params, before=None) -> list[dict]:
    """Kernel B4 at each captured pass: its ms (CUDA events, a mean of 10
    after a warm-up), launches in one call, the plain version's ms (one
    call), agreement with it (b4_agreement), the bound and, with `before`
    (a module with `_median_plane_chunked`), that version's ms."""
    from tsar_mvs_tpu_torch.ops import cuda_wmf, wmf
    out = []
    for name, call in zip(pass_names(params), calls):
        args = b4_args(call)
        H, W = call["gray"].shape
        O = len(call["offsets"])
        n0 = trace.counter("launches.b4")
        mk = wmf.median_plane(*args)
        launches = trace.counter("launches.b4") - n0
        mp = wmf._median_plane_plain(*args)
        res = {"pass": name, "grid": [H, W], "radius": call["radius"],
               "gap": cuda_wmf.gap_of(call["offsets"]), "O": O,
               "launches_a_call": launches, **b4_agreement(mk, mp)}
        del mk, mp
        res["ms"] = time_ms(lambda: wmf.median_plane(*args), 10)
        res["plain_ms"] = time_ms(lambda: wmf._median_plane_plain(*args), 1,
                                  warmup=0)
        if before is not None:
            res["before_ms"] = time_ms(
                lambda: before._median_plane_chunked(*args, 256), 1,
                warmup=0)
        res.update(b4_bound(H, W, O))
        print(f"B4 pass: {json.dumps(res)}", flush=True)
        out.append(res)
    return out


def load_wmf_before(path: str):
    """An older checkout's `ops/wmf.py` as a module of its own (its
    imports resolve to this package). Only a checkout from before B4 has
    the `_median_plane_chunked` that `--before` times."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("wmf_before", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "_median_plane_chunked"):
        raise SystemExit(f"{path} has no _median_plane_chunked: --before "
                         f"takes the ops/wmf.py of a checkout from before B4")
    return mod


def time_b4_all(scene, dev, before: str | None) -> dict:
    """B4 at the ten passes of view 0 (time_b4), its registers and
    spills, and launches a view."""
    import torch
    from tsar_mvs_tpu_torch import _build
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    params = AlgorithmParams()
    trace.clear("launches.b4")
    calls = view_inputs(scene, params, dev)["wmf"]
    torch.cuda.synchronize()
    res = {"launches_a_view": trace.counter("launches.b4"),
           "passes": time_b4(calls, params, before and load_wmf_before(
               before)),
           "resources": [r for r in _build.kernel_resources()
                         if r.startswith("wmf")]}
    return res


# What each part of B4 costs: csrc/wmf.cu with that part taken out (a
# text replacement; the results are then wrong, only the time counts).
B4_PARTS = {
    "sort": [("sort16(k);", ";")],
    "merges": [("merge_lanes(v, s);", ";")],
    "sums": [("for (int j = 0; j < PER_LANE; ++j) add_if<strict>(acc, k[j], "
              "p, w[j]);", "add_if<strict>(acc, k[0], p, w[0]);")],
    "trees": [("""  p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 4));
  p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 2));
  p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 1));""", "")],
    "searches": [("const int h = search(split, w, k, half);",
                  "const int h = k[0] & 31;"),
                 ("const int at = search(split, w, k, half);",
                  "const int at = k[1] & 31;")],
    "key_gathers": [("k[j] = ordered_key(field[step * (int)k[j]]);",
                     "k[j] = ordered_key(__int_as_float(k[j] * 2654435761u "
                     "+ c));")],
    "weight_gathers": [("""      const float gq = gray[q[j]];
      const bool rq = reliable[q[j]];""", """      const float gq = __int_as_float(q[j]);
      const bool rq = q[j] & 1;""")],
    "donor": [("    if (c == 0) {\n      // The donor",
               "    if (c == 4) {\n      // The donor")],
}


@contextlib.contextmanager
def variant_libraries(variants: dict, symbols, tag: str):
    """Each of `variants` ({name: CUDA source text}) built by one nvcc
    into a library of its own, all started together, and loaded with
    ctypes with the argument types `_build.SIGNATURES` gives `symbols`:
    {name: (library, ptxas's registers and spills)}, alive while open."""
    import ctypes
    import tempfile
    from tsar_mvs_tpu_torch import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        procs = {}
        for name, text in variants.items():
            so, cu = Path(tmp) / f"{name}.so", Path(tmp) / f"{name}.cu"
            cu.write_text(text)
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                 str(so), str(cu)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        libs = {}
        for name, proc in procs.items():
            log = proc.communicate()[1]
            if proc.returncode != 0:
                raise SystemExit(f"{tag}: nvcc failed on {name}:\n{log}")
            lib = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))
            for sym in symbols:
                getattr(lib, sym).argtypes = _build.SIGNATURES[sym]
                getattr(lib, sym).restype = ctypes.c_int
            libs[name] = (lib, _build.kernel_resources(log))
        yield libs


def time_b4_parts(calls: list, params, repeats: int = 2) -> dict:
    """B4's ms at the widest marking pass and the first fill pass of
    `calls` (mark 0, fill 0) as built from csrc/wmf.cu and with each part
    of B4_PARTS taken out (each variant one nvcc, all started together),
    `repeats` rounds in alternating order: {pass: {variant: [ms, ...]}}."""
    import torch
    from tsar_mvs_tpu_torch import _build
    from tsar_mvs_tpu_torch.ops import wmf
    src = (_build.CSRC / "wmf.cu").read_text()
    variants = {"whole": src}
    for part, edits in B4_PARTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"b4-parts: {part}: csrc/wmf.cu has no "
                                 f"{old!r}")
            text = text.replace(old, new)
        variants[f"no_{part}"] = text
    with variant_libraries(variants, ["tsar_wmf_median"], "b4-parts") as libs:
        out = {}
        loaded = _build.load_library()
        try:
            for name, call in zip(pass_names(params), calls):
                if name not in ("mark 0", "fill 0"):
                    continue
                args = b4_args(call)
                times: dict = {v: [] for v in variants}
                for r in range(repeats):
                    for v in (list(variants) if r % 2 == 0
                              else list(variants)[::-1]):
                        _build._lib = libs[v][0]
                        times[v].append(time_ms(
                            lambda: wmf.median_plane(*args), 10))
                print(f"B4 parts, {name}: {json.dumps(times)}", flush=True)
                out[name] = times
        finally:
            _build._lib = loaded
            torch.cuda.synchronize()
        return out


# Float operations of B5's function, whatever computes it: a residual
# |((x a + y b) + z c) + d| < thr is 3 multiplies, 3 adds, the absolute
# value and the compare; a hypothesis's plane 30 (two differences, the
# cross product, its norm and test, three divisions, the offset); an
# annealing candidate 15 (the add, the norm, four divisions). Bytes: the
# points (12 a point), the triplets (12 a hypothesis), the perturbations
# (64 a step of 4) and 12 a region of inputs read, 24 a region written.
B5_FLOPS_PER_RESIDUAL = 8
B5_FLOPS_PER_HYPOTHESIS = 30
B5_FLOPS_PER_CANDIDATE = 15


def b5_flops(n, rounds: int, anneal_rounds: int) -> int:
    """Float operations of B5 on regions of n points each: per region
    (rounds x 1001 + 4 anneal_rounds) n residuals (each round's 1000
    hypotheses and its threshold probe, each annealing step's candidate),
    the hypotheses' planes and the candidates."""
    hyp = RANSAC_HYPOTHESES
    per_point = (rounds * (hyp + 1) + 4 * anneal_rounds) \
        * B5_FLOPS_PER_RESIDUAL
    return sum(int(m) * per_point + rounds * hyp * B5_FLOPS_PER_HYPOTHESIS
               + 4 * anneal_rounds * B5_FLOPS_PER_CANDIDATE for m in n)


def b5_bound(n, rounds: int, anneal_rounds: int) -> dict:
    """B5's bound on regions of n points: the larger of its bytes over
    3.35 TB/s and its operations (b5_flops) over 67 TFLOP/s, and its
    ceiling, the operations at half that rate (`ceiling_ms`: every
    operation counted is one rounded add or multiply)."""
    R = len(n)
    nbytes = (12 * int(sum(n)) + 12 * R * rounds * RANSAC_HYPOTHESES
              + 64 * R * anneal_rounds + 8 * (R + 1) + 12 * R + 24 * R)
    flops = b5_flops(n, rounds, anneal_rounds)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": t_bytes,
            "operations_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ceiling_ms": max(t_bytes, 2.0 * t_ops)}


@contextlib.contextmanager
def recording_ransac_inputs(calls: list, fits: list | None = None):
    """While open, every `ransac.ransac_regions` call (one a view) appends
    its RansacInputs to `calls` (tensors cloned) and, with `fits`, every
    `tsar.fit_region_planes` call its arguments after the generator
    (weak, disp cloned, reliable copied, cams, params); both then run as
    before."""
    from tsar_mvs_tpu_torch.models import ransac, tsar
    inner, inner_fit = ransac.ransac_regions, tsar.fit_region_planes

    def record(inp):
        calls.append(ransac.RansacInputs(*(
            t.clone() if hasattr(t, "clone") else t for t in inp)))
        return inner(inp)

    def record_fit(generator, weak, disp, reliable, cams, params):
        fits.append((weak, disp.clone(), reliable.copy(), cams, params))
        return inner_fit(generator, weak, disp, reliable, cams, params)

    ransac.ransac_regions = record
    if fits is not None:
        tsar.fit_region_planes = record_fit
    try:
        yield calls
    finally:
        ransac.ransac_regions = inner
        tsar.fit_region_planes = inner_fit


def view_inputs(scene, params, dev, view: int = 0, wmf: bool = True,
                halfpass: bool = False) -> dict:
    """The inputs of view `view`'s WMF passes ("wmf"; none without
    `wmf`), of its RANSAC call ("ransac", RansacInputs), of its
    fit_region_planes ("fit") and, with `halfpass`, of each pyramid
    level's first propagation and refinement half-pass ("halfpass",
    recording_halfpasses) as `process_view` with `params` gives them (one
    run, its artifacts in a temporary directory)."""
    import tempfile
    from tsar_mvs_tpu_torch import pipeline
    calls: dict = {"wmf": [], "ransac": [], "fit": [], "halfpass": []}
    with tempfile.TemporaryDirectory() as tmp, \
            (recording_wmf_inputs(calls["wmf"]) if wmf
             else contextlib.nullcontext()), \
            (recording_halfpasses(calls["halfpass"]) if halfpass
             else contextlib.nullcontext()), \
            recording_ransac_inputs(calls["ransac"], calls["fit"]):
        pipeline.process_view(scene, view, params, out_dir=Path(tmp),
                              device=dev)
    return calls


def region_sizes(inp) -> list[int]:
    """The point count of each region of a RansacInputs."""
    off = inp.offsets.tolist()
    return [b - a for a, b in zip(off[:-1], off[1:])]


def b5_agreement(mk, mp) -> dict:
    """Largest |delta| of B5's outputs (plane, count, threshold) against
    the plain version's on their int32 views, and their largest as
    "max_abs_err"."""
    import torch
    out = {}
    for name, a, b in zip(("plane", "count", "threshold"), mk, mp):
        ai = a.contiguous().view(torch.int32).to(torch.int64)
        bi = b.contiguous().view(torch.int32).to(torch.int64)
        out[name] = int((ai - bi).abs().max())
    out["max_abs_err"] = max(out.values())
    return out


# The stress inputs of B5 (`ransac_cases`): those packed together in one
# call, and one that needs a pack of its own (its own annealing rounds:
# the deltas of a pack share them).
RANSAC_CASES = ("three", "equal", "collinear", "inf", "ties", "thr_max",
                "plane", "many", "big")
RANSAC_ALONE = ("odd_steps",)


def odd_anneal_rounds(anneal_rounds: int) -> int:
    """The annealing rounds of "odd_steps": the first count above
    `anneal_rounds` whose 4 steps a round leave a part pass at the end
    (4 a not a multiple of the kernel's LOOKAHEAD; a LOOKAHEAD that
    divides 4 has none, and then the next count)."""
    from tsar_mvs_tpu_torch.ops import cuda_ransac
    L = cuda_ransac.LOOKAHEAD
    return next((a for a in range(anneal_rounds + 1, anneal_rounds + 1 + L)
                 if 4 * a % L), anneal_rounds + 1)


def ransac_cases(n_big: int, rounds: int, anneal_rounds: int, dev,
                 thr_max: float = 0.003, thr_step: float = 0.0001,
                 seed: int = 0, n_over: int | None = None) -> dict:
    """Regions that stress B5, each case a list of regions (points (N, 3),
    idx, deltas, thr0) on `dev`, made with numpy from `seed` (the same on
    every device): "three", a triangle (N = 3); "equal", 64 equal points
    (every triplet degenerate); "collinear", 64 points on a line whose
    differences are exact (every triplet degenerate); "inf", 500 points
    on a plane, one with an infinite coordinate; "ties", 12 points on
    three parallel planes, 4 a plane (counts tied across hypotheses);
    "thr_max", 2,000 points scattered in a box with the threshold
    starting half the rounds' steps below thr_max (it climbs there and
    stops); "plane", n_big points on a plane with 30% outliers; "many",
    40 regions of 3 to 2,000 points (log-uniform sizes, each on a plane
    of its own with 20% outliers) beside two large ones of n_big // 2 and
    2 CLUSTER_MIN_POINTS + 1 points (the annealing's one-block and
    whole-cluster units in one launch); "big", n_over points on a plane
    with 30% outliers, by default one more than a cluster holds in
    shared memory (CLUSTER x SMEM_POINTS: its annealing reads global
    memory); "odd_steps", 2,000 points on a plane with 30% outliers and
    `odd_anneal_rounds(anneal_rounds)` annealing rounds (a part pass at
    the end)."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch.models import ransac
    from tsar_mvs_tpu_torch.ops import cuda_ransac
    rng = np.random.default_rng(seed)

    def on_plane(g, m, noise, outliers=0.0, tilt=(0.2, -0.1)):
        xy = g.uniform(-1.0, 1.0, (m, 2))
        z = 3.0 + tilt[0] * xy[:, 0] + tilt[1] * xy[:, 1] \
            + noise * g.standard_normal(m)
        p = np.column_stack([xy, z])
        if outliers:
            out = g.random(m) < outliers
            p[out] = g.uniform(-1.0, 4.0, (int(out.sum()), 3))
        return p

    def region(g, p, n_rounds, n_anneal, thr0=None):
        p = p.astype(np.float32)
        idx = g.integers(0, len(p), (n_rounds, RANSAC_HYPOTHESES, 3))
        u = g.random((n_anneal, 4, 4), dtype=np.float32)
        return (torch.as_tensor(p, device=dev),
                torch.as_tensor(idx.astype(np.int32), device=dev),
                ransac.deltas_from_uniform(torch.as_tensor(u, device=dev)),
                ransac.initial_threshold(len(p)) if thr0 is None else thr0)

    t = np.arange(64.0)
    grid = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    plane = on_plane(rng, n_big, 1e-4)
    out = rng.random(n_big) < 0.3
    plane[out] = rng.uniform(-1.0, 4.0, (int(out.sum()), 3))
    inf = on_plane(rng, 500, 1e-4)
    inf[7, 0] = np.inf
    pts = {"three": np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 1.2],
                              [0.0, 1.0, 0.9]]),
           "equal": np.tile([0.3, -0.2, 2.0], (64, 1)),
           "collinear": np.column_stack([0.25 * t, 0.5 * t,
                                         0.75 * t + 1.0]),
           "inf": inf,
           "ties": np.concatenate([np.column_stack([grid, np.full(4, z)])
                                   for z in (1.0, 2.0, 3.0)]),
           "thr_max": rng.uniform(-1.0, 1.0, (2000, 3)),
           "plane": plane}
    cases = {}
    for name in RANSAC_CASES[:7]:
        thr0 = (thr_max - (rounds // 2 - 0.5) * thr_step
                if name == "thr_max" else 1e-3 if name == "ties" else None)
        cases[name] = [region(rng, pts[name], rounds, anneal_rounds, thr0)]
    g = np.random.default_rng(seed + 1)
    sizes = np.round(np.exp(g.uniform(np.log(3.0), np.log(2000.0), 40)))
    sizes[:2] = 3, 2000
    sizes = [*sizes.astype(int).tolist(), n_big // 2,
             2 * cuda_ransac.CLUSTER_MIN_POINTS + 1]
    cases["many"] = [region(g, on_plane(g, m, 1e-4, 0.2,
                                        g.uniform(-0.3, 0.3, 2)), rounds,
                            anneal_rounds) for m in sizes]
    if n_over is None:
        n_over = cuda_ransac.CLUSTER * cuda_ransac.SMEM_POINTS + 1
    cases["big"] = [region(g, on_plane(g, n_over, 1e-4, 0.3), rounds,
                           anneal_rounds)]
    cases["odd_steps"] = [region(g, on_plane(g, 2000, 1e-4, 0.3), rounds,
                                 odd_anneal_rounds(anneal_rounds))]
    return cases


def pack_cases(cases: dict, names, thr_max: float = 0.003,
               thr_step: float = 0.0001):
    """RansacInputs of the regions of the cases `names` of
    `ransac_cases`, in order."""
    from tsar_mvs_tpu_torch.models import ransac
    cols = list(zip(*(reg for n in names for reg in cases[n])))
    return ransac.pack_regions(*cols, thr_max, thr_step)


def case_packs() -> list:
    """The packs B5 is held to its plain version on: each case alone, the
    cases of RANSAC_CASES all in one call, and each of RANSAC_ALONE."""
    return ([(c,) for c in RANSAC_CASES] + [RANSAC_CASES]
            + [(c,) for c in RANSAC_ALONE])


def chain_inputs(inp):
    """A RansacInputs of one region of 3 points with `inp`'s rounds and
    annealing steps: B5's time on it is the latency of its dependent
    steps with almost no work."""
    import torch
    from tsar_mvs_tpu_torch.models import ransac
    dev = inp.points.device
    rounds, anneal = inp.idx.shape[1], inp.deltas.shape[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, deltas = ransac.draw_region(gen, 3, rounds * RANSAC_HYPOTHESES,
                                     anneal)
    return ransac.pack_regions([inp.points[:3]], [idx], [deltas],
                               [float(inp.thr0[0])], inp.thr_max,
                               inp.thr_step)


def b5_call(kernel, inp):
    """`kernel.ransac_regions` (a version of ops/cuda_ransac.py) on
    RansacInputs `inp`, with models/ransac.py's constants."""
    from tsar_mvs_tpu_torch.models import ransac
    return kernel.ransac_regions(
        inp.points, inp.offsets, inp.idx, inp.deltas, inp.thr0, inp.total,
        inp.gain, inp.thr_max, inp.thr_step, ransac.RATIO, ransac.EPS,
        ransac.TINY)


def alternated_ms(inp, before, repeats: int) -> dict:
    """B5's ms on RansacInputs `inp` (CUDA events, a mean of `repeats`
    calls after a warm-up) and, with `before` (an older checkout's
    ops/cuda_ransac.py, `load_before`), that kernel's too, alternated:
    before, this, this, before. {"this": [ms, ...], "before": [...]}."""
    from tsar_mvs_tpu_torch.ops import cuda_ransac
    order = [("this", cuda_ransac)]
    if before is not None:
        order = [("before", before), *order * 2, ("before", before)]
    times: dict = {}
    for name, kern in order:
        times.setdefault(name, []).append(
            time_ms(lambda: b5_call(kern, inp), repeats))
    return times


def time_b5(calls: list, before=None) -> list[dict]:
    """Kernel B5 on each recorded RansacInputs: its ms (CUDA events, a
    mean of 10 after a warm-up), launches in one call, agreement with the
    plain version (b5_agreement), the plain version's ms (one call), the
    chain's ms (B5 on `chain_inputs`), the rounds' ms (B5 on the same
    inputs with no annealing round) and the annealing's (the rest; and
    alone, with no round), the regions' sizes and the bound. With `before`
    (an older checkout's ops/cuda_ransac.py, `load_before`) that kernel on
    the same inputs too, alternated: before, this, this, before ("ms" is
    then the mean of this kernel's two), its agreement and its split."""
    from tsar_mvs_tpu_torch.models import ransac
    from tsar_mvs_tpu_torch.ops import cuda_ransac
    out = []
    for inp in calls:
        n = region_sizes(inp)
        n0 = trace.counter("launches.b5")
        mk = ransac.ransac_regions(inp)
        launches = trace.counter("launches.b5") - n0
        mp = ransac.ransac_regions_plain(inp)
        rounds, anneal = inp.idx.shape[1], inp.deltas.shape[1]
        res = {"regions": len(n), "points": n, "rounds": rounds,
               "anneal_rounds": anneal, "launches_a_call": launches,
               **b5_agreement(mk, mp)}
        no_anneal = inp._replace(deltas=inp.deltas[:, :0].contiguous())
        no_rounds = inp._replace(idx=inp.idx[:, :0].contiguous())
        kernels = {"": cuda_ransac}
        if before is not None:
            res["before_agreement"] = b5_agreement(b5_call(before, inp), mp)
            kernels["before_"] = before
        res["ms_each"] = alternated_ms(inp, before, 10)
        for pre, kern in kernels.items():
            ms = res["ms_each"][pre[:-1] or "this"]
            res[pre + "ms"] = sum(ms) / len(ms)
            res[pre + "rounds_ms"] = time_ms(
                lambda: b5_call(kern, no_anneal), 10)
            res[pre + "anneal_alone_ms"] = time_ms(
                lambda: b5_call(kern, no_rounds), 10)
            res[pre + "anneal_ms"] = res[pre + "ms"] - res[pre + "rounds_ms"]
        res["plain_ms"] = time_ms(lambda: ransac.ransac_regions_plain(inp),
                                  1, warmup=0)
        chain = chain_inputs(inp)
        res["chain_ms"] = time_ms(lambda: ransac.ransac_regions(chain), 10)
        res.update(b5_bound(n, rounds, anneal))
        print(f"B5 call: {json.dumps(res)}", flush=True)
        out.append(res)
    return out


def time_b5_views(views: list, before=None) -> list[dict]:
    """B5 on the RANSAC call of each refining view, [(view, RansacInputs
    or None)]: the regions' sizes, its ms (CUDA events, a mean of 5),
    its agreement with the plain version and, with `before`, that
    kernel's ms, alternated: before, this, this, before."""
    from tsar_mvs_tpu_torch.models import ransac
    out = []
    for view, inp in views:
        res = {"view": view, "points": [] if inp is None
               else region_sizes(inp)}
        if inp is not None:
            res.update(b5_agreement(ransac.ransac_regions(inp),
                                    ransac.ransac_regions_plain(inp)))
            for k, v in alternated_ms(inp, before, 5).items():
                res[("" if k == "this" else k + "_") + "ms"] = sum(v) / len(v)
        print(f"B5 view: {json.dumps(res)}", flush=True)
        out.append(res)
    return out


def scene_ransac_inputs(scene, params, dev) -> list:
    """[(view, its RANSAC call's RansacInputs, or None for a view
    without a trueweak region of 3 reliable points)] of every view of the
    scene, each run through `process_view` with `params`."""
    out = []
    for view in range(len(scene.names)):
        calls = view_inputs(scene, params, dev, view, wmf=False)["ransac"]
        out.append((view, calls[0] if calls else None))
    return out


def first_ransac_split(scene, dev) -> list[dict]:
    """The parts of the `ransac` stage in this process's first
    `process_view` (view 0: the process's first RANSAC) and in the next
    (view 0 again), host seconds, each part synchronised before and
    after: the draws (`ransac.draw_region`, every region), B5
    (`ransac.ransac_regions`), the polish (`ransac.polish`) and inside it
    the batched `torch.linalg.eigh`, and `fit_region_planes` in all (the
    rest of it: the masks and points on the host). Runs before any other
    RANSAC of the process."""
    import tempfile
    import torch
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.models import ransac, tsar
    parts: dict = {}
    hooks = [(tsar, "fit_region_planes", "fit"),
             (ransac, "draw_region", "draws"),
             (ransac, "ransac_regions", "b5"), (ransac, "polish", "polish"),
             (torch.linalg, "eigh", "eigh")]
    saved = [getattr(obj, attr) for obj, attr, _ in hooks]

    def timed_part(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return res
        return run

    out = []
    try:
        for (obj, attr, name), fn in zip(hooks, saved):
            setattr(obj, attr, timed_part(name, fn))
        for _ in range(2):
            parts.clear()
            with tempfile.TemporaryDirectory() as tmp:
                pipeline.process_view(scene, 0, AlgorithmParams(),
                                      out_dir=Path(tmp), device=dev)
            out.append(dict(parts))
    finally:
        for (obj, attr, _), fn in zip(hooks, saved):
            setattr(obj, attr, fn)
    print(f"first RANSAC, then the next, seconds: {json.dumps(out)}",
          flush=True)
    return out


def load_before(checkout: str) -> dict:
    """An older checkout's RANSAC path as modules of their own: its
    `_build` ("build", which builds that checkout's csrc/ into its own
    build/ directory), its `ops/cuda_ransac.py` on that build
    ("cuda_ransac"; None in a checkout from before B5), its
    `models/ransac.py` on that wrapper and its `models/tsar.py` on that
    ransac ("tsar"); their other imports resolve to this package."""
    import importlib.util
    root = Path(checkout) / "tsar_mvs_tpu_torch"

    def load(name: str, rel: str):
        path = root / rel
        if not path.exists():
            return None
        spec = importlib.util.spec_from_file_location(f"{name}_before", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    mods = {"build": load("_build", "_build.py"),
            "cuda_ransac": load("cuda_ransac", "ops/cuda_ransac.py"),
            "ransac": load("ransac", "models/ransac.py")}
    if mods["cuda_ransac"] is not None:
        mods["cuda_ransac"]._build = mods["build"]
        mods["ransac"].cuda_ransac = mods["cuda_ransac"]
    mods["tsar"] = load("tsar", "models/tsar.py")
    mods["tsar"].ransac = mods["ransac"]
    return mods


def time_ransac_stage(fits: list, before=None, seed: int = 0) -> dict:
    """The `ransac` stage (fit_region_planes: masks, draws, the fit and
    the polish) on each recorded view's arguments, host seconds after a
    synchronisation, with a generator seeded `seed` each run; with
    `before` (an older checkout's models/tsar.py, `load_before`) that
    checkout's fit_region_planes too, alternated: before, this, this,
    before."""
    import torch
    from tsar_mvs_tpu_torch.models import tsar
    runs = [("this", tsar)]
    if before is not None:
        runs = [("before", before), ("this", tsar), ("this", tsar),
                ("before", before)]
    out: dict = {name: [] for name, _ in runs}
    for name, mod in runs:
        for args in fits:
            gen = torch.Generator(device=args[1].device).manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.fit_region_planes(gen, *args)
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    print(f"ransac stage seconds: {json.dumps(out)}", flush=True)
    return out


def time_b5_all(scene, dev, before: str | None) -> dict:
    """The process's first RANSAC split into its parts
    (first_ransac_split), B5 on view 0's recorded regions (time_b5), its
    registers and spills, launches a view, B5 on every refining view of
    the scene (time_b5_views) and the ransac stage; with `before` (an
    older checkout's root) that checkout's B5 kernel and ransac stage
    beside this one's."""
    import torch
    from tsar_mvs_tpu_torch import _build
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    first = first_ransac_split(scene, dev)
    old = load_before(before) if before is not None else {}
    params = AlgorithmParams()
    trace.clear("launches.b5")
    calls = view_inputs(scene, params, dev, wmf=False)
    torch.cuda.synchronize()
    res = {"first_call": first,
           "launches_a_view": trace.counter("launches.b5"),
           "calls": time_b5(calls["ransac"], old.get("cuda_ransac")),
           "views": time_b5_views(scene_ransac_inputs(scene, params, dev),
                                  old.get("cuda_ransac")),
           "stage": time_ransac_stage(calls["fit"], old.get("tsar")),
           "resources": [r for r in _build.kernel_resources()
                         if r.startswith("ransac")]}
    return res


# B5's design choices that `b5-design` sweeps: the annealing's blocks a
# cluster, steps a pass and threads a block (csrc/ransac.cu's CLUSTER,
# LOOKAHEAD and ANNEAL_THREADS).
B5_DESIGN = {"CLUSTER": (1, 4, 8, 16), "LOOKAHEAD": (1, 2, 3, 4),
             "ANNEAL_THREADS": (128, 256)}
# What each part of B5's annealing pass costs (`b5-parts`): csrc/ransac.cu
# with that part taken out (the results are then wrong, only the time
# counts): the candidates' normalisation (a plain add instead), the
# counts over the points, and the unit's exchange (each block stores its
# counts into its own shared memory instead of its unit's blocks', and
# waits for none of them).
B5_PARTS = {
    "tree": [("      if (lev == j) candidate(base, dl, eps, cd);",
              "      if (lev == j)\n        for (int i = 0; i < 4; ++i) "
              "cd[i] = __fadd_rn(base[i], dl[i]);")],
    "count": [("          c[n] += residual(q.x, q.y, q.z, cp[n]) < thr;",
               "          ;")],
    "exchange": [("const unsigned dst = t / STORES;",
                  "const unsigned dst = crank;")],
}


def b5_variant_sources(edits: dict) -> dict:
    """{name: csrc/ransac.cu with that name's (old, new) text edits}."""
    from tsar_mvs_tpu_torch import _build
    src = (_build.CSRC / "ransac.cu").read_text()
    out = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"{name}: csrc/ransac.cu has no {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def time_b5_variants(variants: dict, inputs: dict, tag: str,
                     repeats: int = 2) -> dict:
    """B5 built from each of `variants` ({name: source text}; one nvcc a
    variant, all started together) on each of `inputs` ({name:
    RansacInputs}): per input and variant its ms (CUDA events, a mean of
    10) in `repeats` rounds of alternating order and its agreement with
    the plain version, and each variant's registers and spills."""
    import torch
    from tsar_mvs_tpu_torch import _build
    from tsar_mvs_tpu_torch.models import ransac
    out: dict = {"inputs": {}}
    with variant_libraries(variants, ["tsar_ransac_regions",
                                      "tsar_ransac_cluster"], tag) as libs:
        loaded = _build.load_library()
        try:
            for name, inp in inputs.items():
                mp = ransac.ransac_regions_plain(inp)
                rows: dict = {v: {"ms": []} for v in variants}
                for v in variants:
                    _build._lib = libs[v][0]
                    rows[v].update(b5_agreement(ransac.ransac_regions(inp),
                                                mp))
                for r in range(repeats):
                    for v in (list(variants) if r % 2 == 0
                              else list(variants)[::-1]):
                        _build._lib = libs[v][0]
                        rows[v]["ms"].append(time_ms(
                            lambda: ransac.ransac_regions(inp), 10))
                print(f"{tag}, {name} {region_sizes(inp)[:8]}: "
                      f"{json.dumps(rows)}", flush=True)
                out["inputs"][name] = rows
        finally:
            _build._lib = loaded
            torch.cuda.synchronize()
        out["resources"] = {v: libs[v][1] for v in variants}
    print(f"{tag} resources: {json.dumps(out['resources'])}", flush=True)
    return out


def time_b5_design(inputs: dict) -> dict:
    """B5 built with every combination of B5_DESIGN's values
    (time_b5_variants), named C<cluster>_L<lookahead>_T<threads>."""
    import itertools
    import re
    from tsar_mvs_tpu_torch import _build
    src = (_build.CSRC / "ransac.cu").read_text()
    edits = {}
    for values in itertools.product(*B5_DESIGN.values()):
        edits["C{}_L{}_T{}".format(*values)] = [
            (re.search(rf"constexpr int {name} = \d+;", src).group(0),
             f"constexpr int {name} = {v};")
            for name, v in zip(B5_DESIGN, values)]
    return time_b5_variants(b5_variant_sources(edits), inputs, "B5 design")


def time_b5_parts(inputs: dict) -> dict:
    """B5 as built and with each part of B5_PARTS taken out
    (time_b5_variants)."""
    edits = {"whole": [], **{f"no_{k}": v for k, v in B5_PARTS.items()}}
    return time_b5_variants(b5_variant_sources(edits), inputs, "B5 parts")


# ---------------------------------------------------------------------------
# Kernel B6: the checkerboard half-pass around the cost kernel
# ---------------------------------------------------------------------------

# Float operations of B6's function, whatever computes it: prop_select a
# bank and position (the sample compares, 1 / d and three 3-term dots
# with their scalings: 11 + 1 + 15 + 3), prop_accept a bank and position
# (the depth 8, the range 2, the accept 1), refine_propose a position (the
# depth and disparity 10, the step 9, the normal 9 + 6 + 3 + 5 + 3, the
# plane 6 and its scalars 19), refine_accept a position (the compare).
B6_FLOPS = {"prop_select": 30, "prop_accept": 11, "refine_propose": 70,
            "refine_accept": 1}


def b6_bytes(kernel: str, H: int, W: int, Hc: int, Wc: int, banks: int,
             taken: int) -> int:
    """Bytes B6's `kernel` must move: each input read once, each output
    written once; the accepts write the `taken` positions' planes, costs,
    ratios and views (28 B) and read only their winners' ratio and view.
    The rays and view vectors are not counted: they follow from (x, y) and
    the 13 constants, so the function need not read them.
    prop_select: the state's normal, d and cost (20 B a pixel) read, per
    bank and position the plane, valid flag and scalars written (29 B);
    prop_accept: per bank and position the plane, flag and cost read
    (21 B), the stored cost read (4 B a position); refine_propose: the
    plane at the position (16 B) and the draws (16 B) read, the plane and
    scalars written (28 B); refine_accept: the proposal's cost and the
    stored cost read (8 B a position), the taken plane and ratio and view
    read (24 B a taken position)."""
    n = Hc * Wc
    if kernel == "prop_select":
        return 20 * H * W + 29 * banks * n
    if kernel == "prop_accept":
        return 21 * banks * n + 4 * n + (28 + 8) * taken
    if kernel == "refine_propose":
        return (16 + 16 + 28) * n
    return 8 * n + (24 + 28) * taken


def b6_bound(kernel: str, H: int, W: int, Hc: int, Wc: int, banks: int,
             taken: int) -> dict:
    """The least time of B6's `kernel` at a shape: the larger of its
    bytes (b6_bytes) over 3.35 TB/s and its operations (B6_FLOPS) over 67
    TFLOP/s."""
    nbytes = b6_bytes(kernel, H, W, Hc, Wc, banks, taken)
    per = banks if kernel.startswith("prop") else 1
    flops = B6_FLOPS[kernel] * per * Hc * Wc
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def recording_halfpasses(calls: list):
    """While open, the first propagation and the first refinement
    half-pass on each grid (every level) append their inputs to `calls`:
    {"kind", "shape" (H, W), "parity", "state" (a copy), "grid",
    "cost_fn", "banks" or "sched" and "draws" (the refinement's, drawn
    from its generator in the order the pass draws them), "min_disp",
    "max_disp"}; the passes then run as before (on the recorded draws).
    It hooks hp.propagation and hp.refinement, which every PatchMatch
    path calls."""
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import halfpass as hp
    prop, refine = hp.propagation, hp.refinement
    seen = set()

    def first(kind, state):
        key = (kind, state.shape)
        if key in seen:
            return False
        seen.add(key)
        return True

    def rec_prop(state, parity, banks, grid, cost_fn, plain=False):
        if first("propagation", state):
            calls.append({"kind": "propagation", "shape": state.shape,
                          "parity": parity, "state": pm._own(state),
                          "grid": grid, "cost_fn": cost_fn,
                          "banks": banks})
        return prop(state, parity, banks, grid, cost_fn, plain)

    def rec_refine(state, parity, grid, cost_fn, sched, draws, min_disp,
                   max_disp, plain=False):
        if sched and first("refinement", state):
            draws = list(draws)
            calls.append({"kind": "refinement", "shape": state.shape,
                          "parity": parity, "state": pm._own(state),
                          "grid": grid, "cost_fn": cost_fn, "sched": sched,
                          "draws": draws, "min_disp": min_disp,
                          "max_disp": max_disp})
        return refine(state, parity, grid, cost_fn, sched, draws, min_disp,
                      max_disp, plain)

    hp.propagation, hp.refinement = rec_prop, rec_refine
    try:
        yield calls
    finally:
        hp.propagation, hp.refinement = prop, refine


def b6_run(call: dict, plain: bool = False):
    """A recorded half-pass run again on a copy of its state: kernel B6
    (or, with `plain`, its plain versions) around the recorded cost
    function. Returns the state."""
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import halfpass as hp
    state = pm._own(call["state"])
    if call["kind"] == "propagation":
        hp.propagation(state, call["parity"], call["banks"], call["grid"],
                       call["cost_fn"], plain=plain)
    else:
        hp.refinement(state, call["parity"], call["grid"], call["cost_fn"],
                      call["sched"], call["draws"], call["min_disp"],
                      call["max_disp"], plain=plain)
    return state


def nan_equal_err(a, b) -> float:
    """Largest |a - b| where both are numbers, +inf where one is NaN and
    the other not (equal NaNs and equal infinities count 0)."""
    import torch
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    if (torch.isnan(a) ^ torch.isnan(b)).any():
        return float("inf")
    same = (a == b) | both_nan
    if bool(same.all()):
        return 0.0
    return float((a - b)[~same].abs().max())


def b6_agreement(mk, mp) -> dict:
    """Per field of two results of B6 (two PlaneStates, Candidates or
    Proposals): the largest |delta| (nan_equal_err; an int field's count
    of mismatches), and their largest float delta as "max_abs_err"."""
    import torch
    out = {}
    for name, a, b in zip(mp._fields, mk, mp):
        if a.dtype in (torch.int32, torch.int64, torch.bool):
            out[name + "_mismatches"] = int((a != b).sum())
        else:
            out[name] = nan_equal_err(a, b)
    out["max_abs_err"] = max(v for k, v in out.items()
                             if not k.endswith("_mismatches"))
    out["mismatches"] = sum(v for k, v in out.items()
                            if k.endswith("_mismatches"))
    return out


def taken_count(new, old) -> int:
    """Pixels whose cost an accept changed (a NaN kept counts as kept)."""
    import torch
    return int((~((new == old) | (torch.isnan(new) & torch.isnan(old))))
               .sum())


def b6_check(call: dict) -> dict:
    """B6 against its plain version on a recorded half-pass: its first
    kernel's outputs (prop_select's candidates or refine_propose's first
    proposal) and the states after the whole half-pass, with the launches
    of the kernel's run."""
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import halfpass as hp
    st, parity, grid = call["state"], call["parity"], call["grid"]
    if call["kind"] == "propagation":
        first = b6_agreement(
            hp.prop_select(st, parity, call["banks"], grid),
            hp.prop_select_plain(st, parity, call["banks"], grid))
    else:
        (dz, dn), (u, r) = call["sched"][0], call["draws"][0]
        args = (st, parity, grid, u, r, call["min_disp"], call["max_disp"],
                dz, dn)
        first = b6_agreement(hp.refine_propose(*args),
                             hp.refine_propose_plain(*args))
    n0 = trace.counter("launches.b6")
    mk = b6_run(call)
    launches = trace.counter("launches.b6") - n0
    mp = b6_run(call, plain=True)
    whole = b6_agreement(mk, mp)
    changed = taken_count(mk.cost, st.cost)
    H, W = call["shape"]
    return {"kind": call["kind"], "grid": list(hp.grid_shape(grid, H, W)),
            "packed": grid.packed, "shape": [H, W], "parity": parity,
            "banks": len(call.get("banks", ())), "launches": launches,
            "taken": changed, "first_kernel": first, "state": whole,
            "max_abs_err": max(first["max_abs_err"], whole["max_abs_err"]),
            "mismatches": first["mismatches"] + whole["mismatches"]}


def b6_stress(call: dict, seed: int = 0) -> dict:
    """A recorded half-pass's inputs made into B6's stress input: the
    state's planes zeroed (d = 0 and normal 0, as border padding) on 5%
    of pixels, NaN in d on 2% (NaN depths) and in the cost on 1%, +inf
    costs on 2% (all-inf banks where they meet), and the cost rounded to
    1/8 on the rest so that bank samples tie; a refinement's draws keep
    u = 0 and 1 - 2^-24 on 1% of positions each."""
    import torch
    gen = torch.Generator(device=call["state"].d.device).manual_seed(seed)
    st = call["state"]
    dev = st.d.device

    def mask(p):
        return torch.rand(st.d.shape, generator=gen, device=dev) < p
    zero, nan_d, nan_c, inf_c = mask(0.05), mask(0.02), mask(0.01), mask(0.02)
    normal = torch.where(zero[..., None], 0.0, st.normal)
    d = torch.where(zero, 0.0, st.d)
    d = torch.where(nan_d, float("nan"), d)
    cost = torch.round(st.cost * 8.0) / 8.0
    cost = torch.where(nan_c, float("nan"), cost)
    cost = torch.where(inf_c, float("inf"), cost)
    out = dict(call, state=st._replace(normal=normal.contiguous(), d=d,
                                       cost=cost))
    if call["kind"] == "refinement":
        draws = []
        for u, r in call["draws"]:
            lo = torch.rand(u.shape, generator=gen, device=dev) < 0.01
            hi = torch.rand(u.shape, generator=gen, device=dev) < 0.01
            u = torch.where(lo, 0.0, torch.where(hi, 1.0 - 2.0 ** -24, u))
            draws.append((u, r))
        out["draws"] = draws
    return out


def on_copies(f, state, n: int):
    """A call of f(copy) on the next of `n` copies of `state`, all made
    now (outside whatever times the calls)."""
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    copies = iter([pm._own(state) for _ in range(n)])
    return lambda: f(next(copies))


def time_b6(calls: list, by_shape=None) -> list[dict]:
    """Each B6 kernel at each recorded half-pass's grid: its ms (CUDA
    events around 20 calls after a warm-up, a mean: the wrapper's host
    time between the launches included), its device_ms (the profiler's
    device time of the kernel, a mean over 20 launches; None when the
    trace is dropped), both for the accepts each on a fresh copy of the
    recorded state (on_copies), the plain version's ms (a mean of 3), its
    bound (b6_bound, with the positions each accept takes) and, from
    `by_shape` (the trace counter launches_by_shape.b6 of a main-path
    run), its
    launches at that shape."""
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import halfpass as hp
    out = []
    for call in calls:
        st, parity, grid = call["state"], call["parity"], call["grid"]
        H, W = call["shape"]
        Hc, Wc = hp.grid_shape(grid, H, W)
        cost_fn = call["cost_fn"]
        if call["kind"] == "propagation":
            banks = call["banks"]
            B = len(banks)
            cands = hp.prop_select(st, parity, banks, grid)
            mv = cost_fn(cands.normal, cands.d,
                         parity if grid.packed else None,
                         scalars=(cands.s0, cands.sx, cands.sy))
            runs = {"prop_select": (
                        lambda: hp.prop_select(st, parity, banks, grid),
                        lambda: hp.prop_select_plain(st, parity, banks,
                                                     grid)),
                    "prop_accept": (
                        lambda s: hp.prop_accept(s, parity, cands, mv, grid),
                        lambda s: hp.prop_accept_plain(s, parity, cands, mv,
                                                       grid))}
        else:
            B = 1
            (dz, dn), (u, r) = call["sched"][0], call["draws"][0]
            args = (st, parity, grid, u, r, call["min_disp"],
                    call["max_disp"], dz, dn)
            prop = hp.refine_propose(*args)
            mv = cost_fn(prop.normal, prop.d,
                         parity if grid.packed else None,
                         scalars=(prop.s0, prop.sx, prop.sy))
            runs = {"refine_propose": (
                        lambda: hp.refine_propose(*args),
                        lambda: hp.refine_propose_plain(*args)),
                    "refine_accept": (
                        lambda s: hp.refine_accept(s, parity, grid, prop,
                                                   mv),
                        lambda s: hp.refine_accept_plain(s, parity, grid,
                                                         prop, mv))}
        for kernel, (fk, fp) in runs.items():
            taken = 0
            if kernel.endswith("accept"):
                # Every timed call updates a fresh copy of the recorded
                # state, made before the timing, so it writes what the
                # bound counts: the positions the first call takes.
                sk = pm._own(st)
                fk(sk)
                taken = taken_count(sk.cost, st.cost)
                del sk
                ms = time_ms(on_copies(fk, st, 21), 20)
                plain_ms = time_ms(on_copies(fp, st, 4), 3)
                # device_times may call twice: 40 copies.
                run_k = on_copies(fk, st, 40)
                dt = device_times(lambda: [run_k() for _ in range(20)])
            else:
                ms = time_ms(fk, 20)
                plain_ms = time_ms(fp, 3)
                dt = device_times(lambda: [fk() for _ in range(20)])
            res = {"kernel": kernel, "kind": call["kind"], "grid": [Hc, Wc],
                   "packed": grid.packed, "banks": B, "ms": ms,
                   "device_ms": (dt["b6"][0] / dt["b6"][1] / 1e3
                                 if dt and dt["b6"][1] else None),
                   "plain_ms": plain_ms, "library_ms": None,
                   **b6_bound(kernel, H, W, Hc, Wc, B, taken),
                   "taken": taken}
            if by_shape is not None:
                res["launches"] = by_shape.get((kernel, Hc, Wc, B), 0)
            print(f"B6 shape: {json.dumps(res)}", flush=True)
            out.append(res)
    return out


def b6_launches(plan: list[dict]) -> int:
    """Kernel B6's launches in one view's pyramid: two a propagation
    half-pass (select, accept) and two a refine scale (propose, accept)."""
    return sum(2 * p["propagation"] + 2 * p["refinement"] for p in plan)


def load_pm_before(checkout: str):
    """An older checkout's PatchMatch as a module of its own: its
    `models/patchmatch.py` on its own `ops/ncc.py` (the reference
    statistics); their other imports resolve to this package."""
    import importlib.util
    root = Path(checkout) / "tsar_mvs_tpu_torch"

    def load(name: str, rel: str):
        spec = importlib.util.spec_from_file_location(f"{name}_before",
                                                      root / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    pm = load("patchmatch", "models/patchmatch.py")
    pm.ncc = load("ncc", "ops/ncc.py")
    return pm


def odd_scene(tmp: Path):
    """view 0's scene of chip_smoke.py phase 8(e)'s odd case: make_scene(500,
    750), 4 views, exported under `tmp` and loaded (its levels 4 and 2
    have an odd side: dense half-passes)."""
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    sg = make_scene(height=500, width=750, num_views=4, seed=0)
    return pipeline.load_scene(sg.export(tmp / "odd"))


def time_b6_all(scene, dev, before: str | None) -> dict:
    """B6 on view 0's pyramid of `scene` and of the odd scene: each
    level's first propagation and refinement half-pass recorded, checked
    against the plain version (b6_check) and timed (time_b6, launches
    from one run of the pyramid), then PatchMatch's split; with `before`
    (an older checkout's root) that checkout's PatchMatch too
    (load_pm_before), alternated before, this, this, before."""
    import tempfile
    import torch
    from tsar_mvs_tpu_torch import pipeline
    params = pipeline.default_params_for_scene(scene)
    out: dict = {"checks": [], "shapes": []}
    with tempfile.TemporaryDirectory() as tmp:
        for name, sc in (("2K", scene), ("odd", odd_scene(Path(tmp)))):
            p = pipeline.default_params_for_scene(sc)
            calls: list = []
            with recording_halfpasses(calls):
                pyramid_runner(sc, p, dev)()
            trace.clear("launches_by_shape.b6")
            pyramid_runner(sc, p, dev)()
            by_shape = trace.by_key("launches_by_shape.b6")
            for call in calls:
                for case, c in (("recorded", call),
                                ("stress", b6_stress(call))):
                    r = {"scene": name, "case": case, **b6_check(c)}
                    print(f"B6 check: {json.dumps(r)}", flush=True)
                    out["checks"].append(r)
            for r in time_b6(calls, by_shape):
                out["shapes"].append({"scene": name, **r})
            del calls
            torch.cuda.empty_cache()
    runs = [("this", None)]
    if before is not None:
        old = load_pm_before(before)
        runs = [("before", old), ("this", None), ("this", None),
                ("before", old)]
    out["split"] = []
    for label, pm in runs:
        torch.cuda.empty_cache()
        res = patchmatch_split(scene, params, dev, pm, f" ({label})")
        res.pop("b1_each_us", None)
        out["split"].append({"run": label, **res})
    return out


def time_all(scene, gt: dict, dev) -> dict:
    """Every B1, B2 and B3 shape, level by level (one level's volumes live
    at a time), B1's windows on the last level, then the PatchMatch
    split."""
    import torch
    from tsar_mvs_tpu_torch import pipeline
    params = pipeline.default_params_for_scene(scene)
    b1, b2, b3, windows = [], [], [], []
    for li in range(len(LEVELS)):
        lv = level_inputs(scene, params, li, dev)
        b2.append(time_b2_level(lv))
        b1.extend(time_b1_level(lv, gt))
        b3.extend(time_b3_level(lv, gt))
        if li == len(LEVELS) - 1:
            windows = time_b1_windows(lv, gt)
        del lv
        torch.cuda.empty_cache()
    split = patchmatch_split(scene, params, dev)
    return {"b1": b1, "b2": b2, "b3": b3, "b1_windows": windows,
            "patchmatch": split}


# --- kernel B7 (weak texture) ----------------------------------------------

# tests/test_torch_pipeline.py's small-scene detector thresholds.
B7_SMALL = dict(weak_text_num=25, hough_thr=12, min_line_length=12,
                max_line_gap=3)
B7_FIELDS = ("labels_full", "labels_small", "text", "cenx", "ceny", "size",
             "counts")


def dashed_image(H: int, W: int, seed: int, lines: int = 5, dash: int = 60,
                 gap: int = 18, width: int = 6):
    """(H, W) float32: a smooth ramp (not integer-valued) crossed by
    `lines` dashed bright strokes at random places and angles: the
    strokes' gaps join the flat areas into large pass-1 regions that the
    Hough split cuts along the strokes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 90 + 20 * (xx / W) + 10 * (yy / H)
    for _ in range(lines):
        cx, cy = rng.uniform(0.2, 0.8) * W, rng.uniform(0.2, 0.8) * H
        th = rng.uniform(0, np.pi)
        d = (xx - cx) * np.sin(th) - (yy - cy) * np.cos(th)
        along = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        on = np.mod(along + rng.uniform(0, dash + gap), dash + gap) < dash
        img[(np.abs(d) < width / 2) & on] = 220
    return img.astype(np.float32)


B7_CASES = ("dashed_0", "dashed_1", "dashed_2", "dashed_odd",
            "dashed_levels1", "integer_levels0", "float_levels0", "constant",
            "noise", "dashed_2k", "dashed_dino")


def b7_case(name: str) -> tuple[object, dict, int]:
    """(gray, AlgorithmParams keywords, pyr_levels) of one of B7's stress
    inputs (B7_CASES): dashed strokes at three seeds, on odd sides, at one
    and at no pyramid level (integer-valued and not: both Roberts
    branches), a constant image (the integer branch after the pyramid),
    noise (no region over the floor) and strokes at the 2K and dino
    sizes."""
    import numpy as np
    mid = dict(weak_text_num=500, hough_thr=40, min_line_length=40,
               max_line_gap=6)
    if name.startswith("dashed_") and name[7:].isdigit():
        return dashed_image(192, 256, int(name[7:])), B7_SMALL, 2
    cases = {
        "dashed_odd": lambda: (dashed_image(193, 257, 0), B7_SMALL, 2),
        "dashed_levels1": lambda: (dashed_image(97, 130, 1), B7_SMALL, 1),
        "integer_levels0": lambda: (np.round(dashed_image(48, 64, 2)),
                                    B7_SMALL, 0),
        "float_levels0": lambda: (dashed_image(48, 64, 2), B7_SMALL, 0),
        "constant": lambda: (np.full((96, 128), 128, np.float32), B7_SMALL,
                             2),
        "noise": lambda: (np.random.default_rng(7).uniform(
            0, 255, (96, 128)).astype(np.float32), B7_SMALL, 2),
        "dashed_2k": lambda: (dashed_image(1344, 2048, 0, dash=170, gap=40,
                                           width=10), {}, 2),
        "dashed_dino": lambda: (dashed_image(480, 640, 0, gap=24), mid, 2)}
    return cases[name]()


def b7_mismatch(got, want) -> dict:
    """Elements that differ, field by field of two WeakTextures (floats
    compared on their int64 views; a shape or dtype that differs is
    named)."""
    import numpy as np
    out = {}
    for f in B7_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if a.shape != b.shape or a.dtype != b.dtype:
            out[f] = f"{a.dtype}{a.shape} against {b.dtype}{b.shape}"
            continue
        if a.dtype.kind == "f":
            a, b = a.view(np.int64), b.view(np.int64)
        out[f] = int((a != b).sum())
    return out


def check_b7(gray, params, pyr_levels: int, dev, name: str) -> dict:
    """B7 against the plain version on one image: the mismatches, the
    region count, the segments each drew and B7's launches against its
    plan."""
    from tsar_mvs_tpu_torch.models import weak_texture as wt
    from tsar_mvs_tpu_torch.ops import cuda_weak_texture as b7
    trace.clear("weak_texture.segments", "launches.b7",
                "weak_texture.plain_calls")
    want = wt.detect_weak_texture(gray, params, pyr_levels)
    plain_segments = trace.counter("weak_texture.segments")
    trace.clear("weak_texture.segments")
    got = wt.detect_weak_texture(gray, params, pyr_levels, device=dev)
    planned = b7.plan(*gray.shape, pyr_levels, params.weak_text_num)
    return {"case": name, "shape": list(gray.shape), "levels": pyr_levels,
            "regions": int(want.num_regions),
            "trueweak": int((want.text == -1).sum()),
            "segments": [plain_segments,
                         trace.counter("weak_texture.segments")],
            "launches": [trace.counter("launches.b7"),
                         len(planned.kernels)],
            "plain_calls": trace.counter("weak_texture.plain_calls"),
            "mismatch": b7_mismatch(got, want)}


def b7_ok(row: dict) -> bool:
    return (all(v == 0 for v in row["mismatch"].values())
            and row["segments"][0] == row["segments"][1]
            and row["launches"][0] == row["launches"][1]
            and row["plain_calls"] == 1)


def b7_bound(H: int, W: int, gray_bytes: int = 4) -> dict:
    """B7's least time: the image read once and the full-size labels
    written once at 3.35 TB/s (its other traffic is on the quarter-size
    level and its operations are few)."""
    nbytes = H * W * (gray_bytes + 4)
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def time_b7(gray, params, dev, repeats: int = 20,
            plain_repeats: int = 3) -> dict:
    """The weak-texture stage at one image: B7's wall milliseconds a call
    (upload to arrays, median of `repeats`), its kernels' device
    milliseconds and its device operations (kernels, copies, fills) a
    call (profiler), the plain version's wall milliseconds (median of
    `plain_repeats`) and the bound."""
    import statistics
    import torch
    from tsar_mvs_tpu_torch.models import weak_texture as wt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call():
        return wt.detect_weak_texture(gray, params, device=dev)

    def wall(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    call()
    ms = wall(call, repeats)
    plain_ms = wall(lambda: wt.detect_weak_texture(gray, params),
                    plain_repeats)
    device_ms, ops, parts = None, None, None
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        dev_ev = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if dev_ev:
            device_ms = sum(e.time_range.elapsed_us() for e in dev_ev
                            if "weak_" in e.name) / 1e3
            ops = len(dev_ev)
            parts = {}
            for e in dev_ev:
                m = re.search(r"weak_(\w+?)_kernel", e.name)
                name = m.group(1) if m else e.name[:24]
                parts[name] = parts.get(name, 0.0) + \
                    e.time_range.elapsed_us()
            break
    return {"shape": list(gray.shape), "ms": ms, "device_ms": device_ms,
            "device_ops": ops, "device_us_by_op": parts,
            "plain_ms": plain_ms,
            **b7_bound(*gray.shape, gray.dtype.itemsize)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.kernel_times")
    p.add_argument("command", choices=("render", "time", "b3", "b4",
                                        "b4-parts", "b5", "b5-design",
                                        "b5-parts", "b6"))
    p.add_argument("scene_dir")
    p.add_argument("--json", default=None, help="write the results here")
    p.add_argument("--before", default=None,
                   help="b4: the ops/wmf.py of a checkout from before B4 "
                        "(its plain WMF) to time beside; b5: the root of "
                        "an older checkout, whose B5 kernel (built from "
                        "its own csrc/) and ransac stage are timed beside; "
                        "b6: the root of an older checkout, whose "
                        "PatchMatch is timed beside")
    ns = p.parse_args(argv)
    scene_dir = Path(ns.scene_dir)
    if ns.command == "render":
        render(scene_dir)
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from tsar_mvs_tpu_torch import pipeline
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    scene = pipeline.load_scene(scene_dir)
    with np.load(scene_dir / "gt_view0.npz") as z:
        gt = {"depth": z["depth"], "normal_world": z["normal_world"]}
    if ns.command == "b4":
        res = time_b4_all(scene, dev, ns.before)
    elif ns.command == "b5":
        res = time_b5_all(scene, dev, ns.before)
    elif ns.command == "b6":
        res = time_b6_all(scene, dev, ns.before)
    elif ns.command in ("b5-design", "b5-parts"):
        from tsar_mvs_tpu_torch.config import AlgorithmParams
        inp = view_inputs(scene, AlgorithmParams(), dev, wmf=False)[
            "ransac"][0]
        cases = ransac_cases(50000, inp.idx.shape[1], inp.deltas.shape[1],
                             dev)
        inputs = {"view 0": inp, "chain": chain_inputs(inp),
                  "many": pack_cases(cases, ["many"]),
                  "odd_steps": pack_cases(cases, ["odd_steps"])}
        res = (time_b5_design if ns.command == "b5-design"
               else time_b5_parts)(inputs)
    elif ns.command == "b4-parts":
        from tsar_mvs_tpu_torch.config import AlgorithmParams
        params = AlgorithmParams()
        res = {"parts": time_b4_parts(
            view_inputs(scene, params, dev)["wmf"], params)}
    else:
        res = (time_all if ns.command == "time" else time_b3_all)(scene, gt,
                                                                  dev)
    res["card"] = card
    if ns.json:
        Path(ns.json).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
