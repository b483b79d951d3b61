#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tsar_mvs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero without the final
line (the 2K scene renders in one spawned process per view):
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   no CUDA device is a failure;
2. build the CUDA kernels from csrc/ (timed, each source's nvcc and the
   link), with ptxas's registers and spills per kernel and kernel B3's
   instances' registers and local bytes from cudaFuncGetAttributes;
3. kernel B2 (s-volume build) against its plain PyTorch version for the
   1344x2048 synthetic scene's cameras, one source view at its full plane
   count: |delta| median 0, q99.9 <= 1.0, max <= 2.0 intensity levels;
4. kernel B1 (s-volume NCC cost of all 7 source views with the top-2
   aggregation, one launch) against its plain version at 672x1024: a
   random and a smooth plane field, 8 candidates with invalid (d = 0)
   ones, both parities and the dense grid, and a 7x5 window (the kernel's
   generic window loop) on one of each; on pixels where either cost is
   below 0.99, median < 5e-4 and q99 < 5e-3, fewer than 1% of all pixels
   off by more than 0.1, invalid candidates exactly cost_max with view
   -1, the ratio within 1e-3 on 99.9% of pixels and the best view equal
   wherever the costs agree and there is no tie;
   then both kernels at every shape the main path launches them at
   (tsar_mvs_tpu_torch/kernel_times.py): milliseconds, the plain
   version's, the bound, the library call's, agreement at that shape;
   and B1's two window loops per window sample at full resolution;
5. the main path: process_view of a 1344x2048, 8-view synthetic scene
   (7 sources, 8 iterations, default AlgorithmParams) with per-stage
   seconds, peak device memory, kernel launch counts (in all and by
   shape, as the wrappers counted them; kernel B4 once per WMF pass, 10
   a view; kernel B5 once) and accuracy against the scene's ground truth
   (acc2_pm and acc2_final must reach 0.95);
   (b) kernel B4 (the WMF weighted median plane) against its plain
   version on the inputs the main path gives its ten passes, recorded
   in a second, untimed run of the view
   (kernel_times.view_inputs), so phase 5's seconds and peak memory
   are the main path's alone: each pass at full size, one
   launch a call, timed beside its bound and its plain version, and cut
   to a 256x384 corner (kernel_times.wmf_crop: the image border,
   all-invalid pixels at every radius, tied keys, +-inf and NaN
   disparities, -0.0), and on the 256x384 stress inputs of its search
   made from each pass's inputs (kernel_times.wmf_cases: keys sorted
   along the offset order, 121 equal keys, a single valid sample, keys
   of both signs, a NaN disparity with most of the weight); every output
   equal on its int32 view;
   (c) kernel B5 (the region RANSAC of a view) against its plain version
   on the RANSAC inputs recorded in the same second run (the view's
   regions, their sizes printed, their points and draws): one counted
   call, timed beside its bound, its ceiling, its dependent chain (B5 on
   3 points), its rounds and annealing apart and its plain version; and
   on the stress inputs of kernel_times.ransac_cases at the view's
   rounds (3 points, 64 equal points, 64 collinear points, a point with
   an infinite coordinate, counts tied across hypotheses, a threshold
   that climbs to thr_max, 50,000 points on a plane with 30% outliers,
   42 regions of 3 to 25,000 points, a region above a cluster's shared
   memory), each alone and all in one call, and on 2,000 points whose
   annealing steps end on a part pass (alone); planes and thresholds
   equal on their int32 views, counts equal;
   (d) kernel B6 (PatchMatch's checkerboard half-pass around B1: its
   candidate selection, refine proposals and accepts) against its plain
   version on the first propagation and refinement half-pass of each of
   view 0's levels, recorded in the same second run with their states
   and draws (kernel_times.recording_halfpasses), and on each one's
   stress input (kernel_times.b6_stress: d = 0 planes, NaN depths and
   costs, +inf costs, tied costs, draws at the ends of [0, 1)): the
   first kernel's outputs and the state after the half-pass equal (max
   |delta| 0.0, NaN at the same places, best views equal), two launches
   a propagation half-pass and two a refine scale; then each B6 kernel
   timed at each level beside its bound and its plain version; view 0's
   pyramid must launch fewer than PYRAMID_LAUNCHES kernels of any kind
   (the profiler's count, kernel_times.patchmatch_split);
   (e) kernel B7 (the weak-texture detection) against its plain version
   (numpy and scipy) on the benchmark's 2K and dino views
   (benchmark/scene.py, the eth3d-2k and middlebury-dino configurations)
   and on kernel_times.B7_CASES (dashed strokes whose gaps the Hough
   split closes, odd sides, one and no pyramid level, a constant image,
   noise): every field of WeakTexture equal to the bit, the same
   segments drawn, B7's launches its plan's; then B7 timed at the 2K and
   dino view 0 (upload to arrays, its kernels' device time) beside its
   bound and the plain version;
6. the scene on the same scene: process_scene(resume=True) runs the 7
   other views (view 0's artifacts from phase 5 are kept), fuse_scene
   with the default FusionParams, and the fused cloud's F1@2cm against
   the GT cloud of utils/synthetic.py::gt_cloud (F1 must reach 0.94,
   every view's acc2_final 0.95; the JAX package's record there is 0.9625,
   RESULTS.md planar:0);
7. the APD prior: view 1 gets APD/<name>/depths_geom.dmb (GT depth with
   0.5% noise, 5% of pixels redrawn within +-30%), normals.dmb (GT
   world normals) and weak.png (0 on the redrawn pixels), then
   process_view three times: as the reference runs the prior (no
   PatchMatch; acc2_final must reach 0.95), and with 2 full-resolution
   PatchMatch iterations from the lifted prior, under the default
   4096 MiB s-volume budget (acc2_final must reach 0.85) and under
   16384 MiB (acc2_final must reach 0.95), both kernels launching in
   each PatchMatch run; and a fourth time with 2 iterations on the
   direct sampler (ncc_impl="direct", no plane spacing; acc2_final must
   reach 0.95), launching kernel B3 only;
8. the direct sampler (kernel B3), one line per part:
   (a) B3 against its plain version at 672x1024 (level 2, within phase
       4's loop): random and smooth fields, 1, 3, 4, 6 and 8 candidates
       with invalid (d = 0) ones, both parities and the dense grid,
       n_best 1, 3 and 5, grayscale and colour, 7 and 9 views, and a 7x5
       window (the generic loop); cost and ratio equal (max |delta| 0.0),
       invalid candidates exactly cost_max with view -1, the best view
       equal off ties;
   (b) B3 timed at every shape the direct path launches, on every level
       in grayscale, with n_best 3 and in colour
       (kernel_times.time_b3_level, phase 4's loop), beside its plain
       version, its bound and the ceiling of a kernel that rounds every
       step; equal to its plain version at each;
   (c) view 0 through process_view with ncc_impl="direct": B3 launches
       once per cost evaluation (kernel_times.launch_plan), B1 and B2
       never; acc2_pm and acc2_final must reach 0.95;
   (d) view 0 of the scene exported as 3-channel PFMs (channels of
       kernel_times.color_from_gray) with color_processing=True, and
       view 0 with n_best=3: both must reach 0.95 (with n_best 3 over
       the pixels seen by at least 3 sources), launching B3 only and
       once per evaluation, and the colour run's PLY colours must equal
       its input;
   (e) images whose pyramid level 2 has an odd side: view 0 of
       make_scene(500, 750) on both samplers, each within 0.02 acc2_pm
       of the same run at 500x752; B6 held to its plain version on the
       odd scene's dense level as in 5(d);
9. the view-sharded scene (tsar_mvs_tpu_torch/parallel/):
   (a) process_scene_sharded on a fresh copy of the 1344x2048x8 scene,
       world 1 in an NCCL group: per-phase seconds (A-F), peak memory,
       B1 launched once per cost evaluation and B2 once per volume of
       every view (8 x phase 5's counts), B3 never, every view's acc2_pm
       and acc2_final (both must reach 0.95), the fused cloud's F1@2cm
       (must reach 0.94) beside phase 6's sequential points and F1;
   (b) two spawned ranks sharing the card in a gloo group against world 1
       on the card, make_scene(336, 512, num_views=4), on the s-volume
       and the direct sampler: depths and normals bit-equal, fused point
       counts equal, every rank on cuda and launching its sampler's
       kernels (B1 and B2, or B3), and B5 once for every view of the two
       ranks that has a trueweak region (at this size none has one);
   (c) the batched runner's call sites of B1, B2 and B3 (batch_sampler,
       make_batch_cost_fn) on both scenes, at every pyramid level with
       the inputs the sharded path gives them (warp factors scaled per
       level, plane counts shared over the batch), one reference a level
       and one of them with a padding slot, on both samplers, both
       parities and dense: each against its plain version on the same
       inputs, at the bounds of phases 3, 4 and 8(a);
10. the harnesses (tsar_mvs_tpu_torch/bench*.py) on phase 5's scene:
   (a) bench.run at 1344x2048x8, 8 iterations, a warm-up and 2 timed
       views: its JSON line; acc2_pm and acc2_final must reach 0.95, the
       crosscheck must say "ok", and every view must launch B1 once per
       cost evaluation and B2 once per volume (kernel_times.launch_plan),
       B3 never; acc2_weak_final beside the TPU record's 1.0; then the
       crosscheck of a direct-sampler bench (B3 too, equal to the bit);
   (b) bench_patchmatch.run on the direct and the s-volume sampler: a line
       each, acc2_pm must reach 0.95, and each run launches its sampler's
       kernels once per evaluation and volume;
   (c) bench_scaling.run_count(1): one spawned NCCL rank at the harness's
       defaults (96x128, 2 iterations, 2 scenes).

Every view of phases 5-10 launches B6 twice a propagation half-pass and
twice a refine scale (312 a 2K view; none of the plain half-pass, whose
calls the trace counter halfpass.plain_calls counts), B7 its plan's
launches (17 at 2K; the plain weak-texture detection never: trace counter
weak_texture.plain_calls), B4 once per WMF
pass (10 a view, 80 in the sharded scene) and B5 once (8 in the sharded
scene; a view without a trueweak region of 3 reliable points launches no
B5, and the checks count such views from the trace counter
ransac.views_without_regions and print them), the crosschecks' and phase 5(b)'s and 5(c)'s launches aside. After phase 5, PatchMatch's seconds split into B1, B2 and the rest
(profiler), and on the direct paths (grayscale, colour, n_best 3) into B3
and the rest, B3 once per evaluation. At the end one JSON line of
per-kernel results (the top-level numbers of a kernel
are those of its level-1 shape, B6's the sum of its four kernels
there, "shapes" holds every timed shape and
"launches_by_shape" the counted launches at each of its main path: B1's,
B2's and B4's the default view's, B3's the direct view's), the card line,
and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

from tsar_mvs_tpu_torch import trace

H, W, VIEWS = 1344, 2048, 8
# Phase 8(e): an image whose pyramid level 2 has an odd side, beside one
# two columns wider whose levels are all even; views of each scene.
ODD, EVEN, ODD_VIEWS = (500, 750), (500, 752), 4


def check_warp(scene, params, dev) -> dict:
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.kernel_times import time_ms
    from tsar_mvs_tpu_torch.ops import cuda_warp
    from tsar_mvs_tpu_torch.ops import svolume as sv
    order, view_ids = pipeline.view_image_order(scene, 0, params.max_views)
    cams = geo.build_camera_set([scene.P[i] for i in order],
                                depth_min=scene.depth_min,
                                depth_max=scene.depth_max, device=dev)
    counts = pipeline.scene_plane_counts(scene, params, (4, 2, 1),
                                         len(view_ids))[-1]
    slot = max(range(len(counts)), key=lambda k: counts[k])
    S = counts[slot]
    s_lo, s_hi = sv.s_range_for_depths(params.depth_min, params.depth_max,
                                       params.svolume_margin)
    ds = (s_hi - s_lo) / (S - 1)
    src = torch.as_tensor(scene.images[order[slot + 1]], device=dev)
    A, b = cams.A[slot + 1], cams.b[slot + 1]

    def kernel():
        return cuda_warp.build_svolume_view(src, A, b, s_lo, ds, S)

    def plain():
        return cuda_warp.build_svolume_view_plain(src, A, b, s_lo, ds, S)

    delta = (kernel().float() - plain().float()).abs().flatten()
    torch.cuda.synchronize()
    q = torch.sort(delta).values
    n = q.numel()
    stats = {"median": float(q[n // 2]), "q99.9": float(q[int(0.999 * (n - 1))]),
             "max": float(q[-1])}
    del q, delta
    res = {"planes": S, "view": order[slot + 1], **stats,
           "ms": time_ms(kernel, 5), "plain_ms": time_ms(plain, 2)}
    ok = stats["median"] == 0.0 and stats["q99.9"] <= 1.0 and stats["max"] <= 2.0
    print(f"B2 warp vs plain: {json.dumps(res)} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("B2 disagrees with its plain version")
    return res


def b1_agreement(mk, mp, invalid, params) -> tuple[dict, bool]:
    """Phase 4's bounds on a B1 result `mk` against its plain version `mp`
    on the same inputs, `invalid` the candidates with d = 0: on the pixels
    where either cost is below 0.99 (more than 30% of them) median |delta|
    < 5e-4 and q99 < 5e-3; under 1% of all pixels off by more than 0.1;
    invalid candidates exactly cost_max with view -1 and ratio 0; the
    ratio within 1e-3 on 99.9% of the pixels; the best view equal wherever
    the costs agree and there is no tie."""
    import torch
    ck, cp = mk.cost, mp.cost
    delta = (ck - cp).abs()
    sharp = (torch.minimum(ck, cp) < 0.99) & ~invalid
    ds_ = delta[sharp] if sharp.any() else delta.new_full((1,), 1.0)
    r_delta = (mk.ratio - mp.ratio).abs()
    untied = (ck == cp) & (mp.ratio != 1.0)
    r = {"sharp_frac": float(sharp.float().mean()),
         "median": float(torch.quantile(ds_[:1 << 24], 0.5)),
         "q99": float(torch.quantile(ds_[:1 << 24], 0.99)),
         "max_sharp": float(ds_.max()), "max": float(delta.max()),
         "frac_gt_0.1": float((delta > 0.1).float().mean()),
         "invalid_exact": bool(
             (ck[invalid] == params.cost_max).all()
             and (cp[invalid] == params.cost_max).all()
             and (mk.best_view[invalid] == -1).all()
             and (mk.ratio[invalid] == 0).all()),
         "ratio_max": float(r_delta.max()),
         "ratio_frac_gt_1e-3": float((r_delta > 1e-3).float().mean()),
         "best_view_mismatches": int(
             (mk.best_view[untied] != mp.best_view[untied]).sum())}
    ok = (r["median"] < 5e-4 and r["q99"] < 5e-3
          and r["frac_gt_0.1"] < 0.01 and r["invalid_exact"]
          and r["sharp_frac"] > 0.3 and r["ratio_frac_gt_1e-3"] < 1e-3
          and r["best_view_mismatches"] == 0)
    return r, ok


def b3_agreement(mk, mp, invalid, params) -> tuple[dict, bool]:
    """Phase 8(a)'s bounds on a B3 result against its plain version: cost
    and ratio equal (max |delta| 0.0: the kernel rounds every step in the
    plain version's order), the best view equal off ties, invalid
    candidates exactly cost_max with view -1, a valid view on more than
    30% of the pixels."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    untied = (mk.cost == mp.cost) & (mp.ratio != 1.0)
    r = {"max": kt.max_abs_diff(mk.cost, mp.cost),
         "ratio_max": kt.max_abs_diff(mk.ratio, mp.ratio),
         "best_view_mismatches": int(
             (mk.best_view[untied] != mp.best_view[untied]).sum()),
         "invalid_exact": bool(
             (mk.cost[invalid] == params.cost_max).all()
             and (mp.cost[invalid] == params.cost_max).all()
             and (mk.best_view[invalid] == -1).all()),
         "valid_frac": float((mk.best_view >= 0).float().mean())}
    ok = (r["max"] == 0.0 and r["ratio_max"] == 0.0
          and not r["best_view_mismatches"] and r["invalid_exact"]
          and r["valid_frac"] > 0.3)
    return r, ok


def check_ncc(lv: dict, gt: dict) -> float:
    """Kernel B1 against its plain version on one level's inputs
    (`kernel_times.level_inputs`): all source views in one launch, 8
    candidates of which one is invalid everywhere and one on 10% of the
    pixels. Returns the largest |delta| of the cost."""
    import dataclasses
    import torch
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    from tsar_mvs_tpu_torch.ops import cuda_ncc, ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    dev = lv["imgs"].device
    Hs, Ws = lv["imgs"].shape[1:]
    vol, params, stats = lv["vol"], lv["params"], lv["stats"]
    g = torch.Generator(device=dev).manual_seed(7)
    C = 8
    invalid = torch.zeros((C, Hs, Ws), dtype=torch.bool, device=dev)
    invalid[7] = True
    invalid[5] = torch.rand((Hs, Ws), generator=g, device=dev) < 0.1
    # The 7x5 window takes the kernel's generic window loop.
    small = dataclasses.replace(params, box_hsize=7, box_vsize=5)
    windows = {(11, 11): (params, stats),
               (7, 5): (small, ncc.precompute_ref_stats(
                   lv["imgs"][0], lv["cams"], small))}
    worst = 0.0
    for field in ("random", "smooth"):
        n, d = (kt.random_field(lv, C, g) if field == "random"
                else kt.smooth_field(lv, gt, C, g))
        d = torch.where(invalid, 0.0, d)
        cases = [((11, 11), parity) for parity in (0, 1, None)]
        cases.append(((7, 5), 0 if field == "random" else None))
        for window, parity in cases:
            params, stats = windows[window]
            if parity is None:
                st, n_p, d_p, inv_p = stats, n, d, invalid
            else:
                st = ncc.compress_stats(stats, parity)
                n_p = cb.parity_compress_vec(n, parity)
                d_p = cb.parity_compress(d, parity)
                inv_p = cb.parity_compress(invalid, parity)
            s0, sx, sy = sv.plane_scalars(n_p, d_p, st)
            args = (vol.data, vol.s_lo, vol.inv_ds, lv["ids"], s0, sx, sy,
                    st, params, parity)
            before = trace.counter("launches.b1")
            mk = cuda_ncc.multiview_cost(*args)
            launches = trace.counter("launches.b1") - before
            mp = cuda_ncc.multiview_cost_plain(*args)
            agree, ok = b1_agreement(mk, mp, inv_p, params)
            r = {"field": field, "parity": parity, "window": list(window),
                 "launches": launches, **agree}
            ok = ok and launches == 1
            worst = max(worst, r["max"])
            print(f"B1 ncc vs plain: {json.dumps(r)} -> "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit("B1 disagrees with its plain version")
    return worst


# Phase 8(a) cases: (field, candidates, parity, n_best, colour, window,
# views). Seven views are the level's sources; nine add two of them again
# under slightly moved warp factors (more views than one group holds at
# one candidate). Candidate counts 3 and 6 leave kernel slots unused;
# n_best 5 with seven views takes the 32-entry aggregation.
B3_CASES = (("random", 8, 0, 1, False, (11, 11), 7),
            ("random", 1, None, 1, False, (11, 11), 7),
            ("smooth", 4, 1, 3, False, (11, 11), 7),
            ("smooth", 1, 0, 1, False, (11, 11), 7),
            ("smooth", 8, None, 3, True, (11, 11), 7),
            ("random", 4, 0, 3, True, (11, 11), 7),
            ("smooth", 1, 1, 1, True, (11, 11), 7),
            ("random", 8, 1, 1, True, (11, 11), 7),
            ("random", 4, 0, 1, False, (7, 5), 7),
            ("random", 1, 0, 1, False, (11, 11), 9),
            ("smooth", 1, None, 3, True, (11, 11), 9),
            ("smooth", 4, 1, 1, False, (11, 11), 9),
            ("smooth", 4, 0, 5, False, (11, 11), 7),
            ("random", 1, 1, 5, True, (11, 11), 7),
            ("smooth", 3, 0, 1, False, (11, 11), 7),
            ("random", 6, None, 3, True, (7, 5), 9))


def nine_views(lv: dict, color: bool):
    """Kernel B3's views for nine sources: the level's seven, then the
    first two again with A scaled by 1.002 and b by 0.998 (distinct warps,
    ids + 100)."""
    import torch
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.ops import cuda_direct
    imgs, ids, cams = lv["imgs"], lv["ids"], lv["cams"]
    if color:
        imgs = kt.color_from_gray(imgs)
    idx = torch.cat([ids, ids[:2]])
    A = torch.cat([cams.A[ids], cams.A[ids[:2]] * 1.002])
    b = torch.cat([cams.b[ids], cams.b[ids[:2]] * 0.998])
    return cuda_direct.make_views(imgs[idx], A, b,
                                  torch.cat([ids, ids[:2] + 100]))


def check_direct(lv: dict, gt: dict) -> float:
    """Phase 8(a): kernel B3 against its plain version on one level's
    inputs, B3_CASES; the last candidate is invalid (d = 0) everywhere and,
    with more than one, another on 10% of the pixels (on 10% of them with
    one). Prints one line; returns the largest |delta| of the cost."""
    import dataclasses
    import torch
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    from tsar_mvs_tpu_torch.ops import cuda_direct, ncc
    from tsar_mvs_tpu_torch.ops import ncc_color as nc
    dev = lv["imgs"].device
    Hs, Ws = lv["imgs"].shape[1:]
    g = torch.Generator(device=dev).manual_seed(11)
    inputs = {(False, 7): kt.direct_inputs(lv, False)[0],
              (True, 7): kt.direct_inputs(lv, True)[0],
              (False, 9): nine_views(lv, False),
              (True, 9): nine_views(lv, True)}
    rgb0 = kt.color_from_gray(lv["imgs"][0])
    cases, ok_all, worst = [], True, 0.0
    for field, C, parity, n_best, color, window, V in B3_CASES:
        params = dataclasses.replace(lv["params"], n_best=n_best,
                                     box_hsize=window[0],
                                     box_vsize=window[1])
        stats = (nc.precompute_ref_stats_color(rgb0, lv["cams"], params)
                 if color else ncc.precompute_ref_stats(lv["imgs"][0],
                                                        lv["cams"], params))
        n, d = (kt.random_field(lv, C, g) if field == "random"
                else kt.smooth_field(lv, gt, C, g))
        invalid = torch.zeros((C, Hs, Ws), dtype=torch.bool, device=dev)
        invalid[-1] = C > 1
        invalid[0] |= torch.rand((Hs, Ws), generator=g, device=dev) < 0.1
        d = torch.where(invalid, 0.0, d)
        if parity is not None:
            stats = (nc.compress_stats_color if color
                     else ncc.compress_stats)(stats, parity)
            n, d = cb.parity_compress_vec(n, parity), cb.parity_compress(
                d, parity)
            invalid = cb.parity_compress(invalid, parity)
        args = (inputs[(color, V)], *ncc.plane_scalars(n, d, stats), stats,
                params, parity)
        before = trace.counter("launches.b3")
        mk = cuda_direct.multiview_cost_direct(*args)
        launches = trace.counter("launches.b3") - before
        mp = cuda_direct.multiview_cost_direct_plain(*args)
        agree, ok = b3_agreement(mk, mp, invalid, params)
        r = {"field": field, "C": C, "parity": parity, "n_best": n_best,
             "channels": 3 if color else 1, "window": list(window),
             "views": V, "launches": launches, **agree}
        ok = ok and launches == 1
        ok_all &= ok
        worst = max(worst, r["max"])
        cases.append({**r, "pass": ok})
        del mk, mp, args, stats
    print(f"B3 direct vs plain (phase 8a): {json.dumps(cases)} -> "
          f"{'PASS' if ok_all else 'FAIL'}", flush=True)
    if not ok_all:
        raise SystemExit("B3 disagrees with its plain version")
    return worst


def check_b4(calls: list) -> tuple[list, int]:
    """Phase 5(b): kernel B4 against its plain version on the main path's
    WMF inputs `calls` (its ten passes): each pass at full size
    (kernel_times.time_b4: one launch a call, timed beside its bound and
    its plain version) and on kernel_times.wmf_crop of it; every output
    equal on its int32 view; and on kernel_times.wmf_cases of every pass
    (the search's stress inputs). Prints one line for the crops and one
    for the cases; returns the full-size rows and the largest |delta|."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.ops import cuda_wmf, wmf
    params = AlgorithmParams()
    if len(calls) != WMF_PASSES:
        raise SystemExit(f"the main path ran {len(calls)} WMF passes, not "
                         f"{WMF_PASSES}")
    crops, ok = [], True
    for name, call in zip(kt.pass_names(params), calls):
        args = kt.b4_args(kt.wmf_crop(call))
        before = trace.counter("launches.b4")
        mk = wmf.median_plane(*args)
        launches = trace.counter("launches.b4") - before
        mp = wmf._median_plane_plain(*args)
        r = {"pass": name, "radius": call["radius"],
             "gap": cuda_wmf.gap_of(call["offsets"]), "launches": launches,
             "all_invalid_pixels": int((mp.num == 0).sum()),
             **kt.b4_agreement(mk, mp)}
        ok &= r["max_abs_err"] == 0 and launches == 1 and \
            r["all_invalid_pixels"] > 0
        crops.append(r)
    print(f"B4 vs plain on 256x384 corners (phase 5b): {json.dumps(crops)} "
          f"-> {'PASS' if ok else 'FAIL'}", flush=True)
    # The search's stress inputs (tests/test_torch_wmf.py): each case of
    # kernel_times.wmf_cases cut from every pass's inputs.
    cases = {}
    for name, call in zip(kt.pass_names(params), calls):
        for case, args in kt.wmf_cases(call, 256, 384).items():
            args = kt.b4_args(args)
            mk = wmf.median_plane(*args)
            mp = wmf._median_plane_plain(*args)
            err = kt.b4_agreement(mk, mp)["max_abs_err"]
            cases[case] = max(cases.get(case, 0), err)
            ok &= err == 0
    print(f"B4 vs plain on the search's stress inputs, largest |delta| of "
          f"the ten passes (phase 5b): {json.dumps(cases)} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    shapes = kt.time_b4(calls, params)
    ok &= all(sh["max_abs_err"] == 0 and sh["launches_a_call"] == 1
              for sh in shapes)
    if not ok:
        raise SystemExit("B4 disagrees with its plain version")
    return shapes, max(max(cases.values()),
                       max(sh["max_abs_err"] for sh in crops + shapes))


def check_b5(calls: list) -> tuple[list, int]:
    """Phase 5(c): kernel B5 against its plain version on the main path's
    RANSAC inputs `calls` (one RansacInputs: view 0's regions, their
    points and draws; kernel_times.time_b5: one counted call, timed
    beside its bound, its chain, its rounds and annealing apart and its
    plain version) and on the stress inputs of kernel_times.ransac_cases
    at the view's rounds and annealing rounds (kernel_times.case_packs:
    each alone, all in one call, and "odd_steps" alone): planes and
    thresholds equal on their int32 views, counts equal. Prints one line
    for the cases; returns the rows of `time_b5` and the largest
    |delta|."""
    import torch
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.models import ransac
    if len(calls) != 1:
        raise SystemExit(f"the main path made {len(calls)} RANSAC calls, "
                         f"not 1")
    shapes = kt.time_b5(calls)
    ok = all(sh["max_abs_err"] == 0 and sh["launches_a_call"] == 1
             for sh in shapes)
    rounds, anneal = calls[0].idx.shape[1], calls[0].deltas.shape[1]
    cases = kt.ransac_cases(50000, rounds, anneal, calls[0].points.device)
    res = {}
    for names in kt.case_packs():
        inp = kt.pack_cases(cases, names)
        before = trace.counter("launches.b5")
        mk = ransac.ransac_regions(inp)
        launches = trace.counter("launches.b5") - before
        mp = ransac.ransac_regions_plain(inp)
        r = {"points": kt.region_sizes(inp), "launches": launches,
             "inliers": mp[1].tolist(), "thr": mp[2].tolist(),
             "delta": kt.b5_agreement(mk, mp)}
        r["max_abs_err"] = r["delta"]["max_abs_err"]
        ok &= r["max_abs_err"] == 0 and launches == 1
        res[names[0] if len(names) == 1 else "all"] = r
    torch.cuda.empty_cache()
    print(f"B5 vs plain on the stress inputs (phase 5c): {json.dumps(res)} "
          f"-> {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("B5 disagrees with its plain version")
    return shapes, max(r["max_abs_err"] for r in [*shapes, *res.values()])


def check_b6(calls: list, label: str) -> tuple[list, float]:
    """Kernel B6 against its plain version on recorded half-passes
    `calls` (kernel_times.recording_halfpasses: each level's first
    propagation and refinement half-pass, their states and draws;
    kernel_times.b6_check) and on each one's stress input
    (kernel_times.b6_stress: d = 0 planes, NaN depths and costs, +inf
    costs, tied costs, draws at 0 and 1 - 2^-24): the first kernel's
    outputs and the state after the half-pass equal (max |delta| 0.0, NaN
    at the same places, best view and valid flags equal), two launches a
    propagation half-pass and two a refine scale. Prints one line;
    returns the rows and the largest |delta|."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    rows, ok = [], True
    for call in calls:
        for case, c in (("recorded", call), ("stress", kt.b6_stress(call))):
            r = {"case": case, **kt.b6_check(c)}
            want = (2 if c["kind"] == "propagation"
                    else 2 * len(c["sched"]))
            ok &= (r["max_abs_err"] == 0 and r["mismatches"] == 0
                   and r["launches"] == want)
            rows.append(r)
    print(f"B6 vs plain ({label}): {json.dumps(rows)} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("B6 disagrees with its plain version")
    return rows, max(r["max_abs_err"] for r in rows)


def acc2_for(scene_gt, scene, ref: int, depth, min_sources: int = 1):
    """acc2 of a depth map over the matchable textured pixels of view
    `ref` (finite GT, not weak, seen by at least `min_sources` sources of
    its pair.txt) and over its weak pixels: {"textured": x, "weak": y}."""
    import numpy as np
    from tsar_mvs_tpu_torch.utils.synthetic import source_coverage
    from tsar_mvs_tpu_torch import pipeline
    order, _ = pipeline.view_image_order(scene, ref, 14)
    gt = scene_gt.depth[ref]
    ok_px = np.isfinite(gt) & ~scene_gt.weak_mask[ref]
    matchable = ok_px & (source_coverage(scene_gt, ref=ref,
                                         src_views=order[1:])
                         >= min_sources)
    weak_sel = np.isfinite(gt) & scene_gt.weak_mask[ref]
    rel = np.abs(depth - gt) / np.where(np.isfinite(gt), gt, 1.0)

    def acc(sel):
        return float((rel[sel] < 0.02).mean()) if sel.any() else 0.0
    return {"textured": acc(matchable), "weak": acc(weak_sel),
            "matchable_frac": float(matchable[ok_px].mean())}


def stage_timer(stages: dict):
    """timer(name) for process_view: seconds since the last boundary,
    after a device synchronisation."""
    import torch
    last = [time.perf_counter()]

    def timer(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now
    return timer


# The kernels by the keys of the launch counts: B1 "ncc", B2 "warp", B3
# "direct", B4 "wmf", B5 "ransac", B6 "halfpass" (trace's launches.b1 ...).
KERNELS = {"ncc": "b1", "warp": "b2", "direct": "b3", "wmf": "b4",
           "ransac": "b5", "halfpass": "b6"}


def reset_launches() -> None:
    """Every wrapper's counts, the count of refined views without a
    RANSAC region and the plain half-pass's calls to 0."""
    trace.clear(*(f"launches.{b}" for b in KERNELS.values()),
                *(f"launches_by_shape.{b}" for b in KERNELS.values()),
                "ransac.views_without_regions", "halfpass.plain_calls",
                "launches.b7", "weak_texture.plain_calls")


def plain_halfpass_calls() -> int:
    """Calls of the plain (torch) half-pass since reset_launches: 0 on the
    card."""
    return trace.counter("halfpass.plain_calls")


def b6_expected(scene, params) -> int:
    """Kernel B6's launches in one view's pyramid of `scene` (its levels
    as process_view picks them): two a propagation half-pass and two a
    refine scale (kernel_times.b6_launches)."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch import pipeline
    params = pipeline.default_params_for_scene(scene, params)
    return kt.b6_launches(kt.launch_plan(
        scene, params, pipeline.pyramid_levels_for(scene.images.shape[1])))


def b5_expected(views: int) -> int:
    """Kernel B5's launches in a run (since reset_launches) that refined
    `views` views: one a view, less the views that had no trueweak region
    of 3 reliable points, for which B5 launches nothing
    (the trace counter ransac.views_without_regions counts them)."""
    return views - trace.counter("ransac.views_without_regions")


def read_launches() -> dict:
    return {k: trace.counter(f"launches.{b}") for k, b in KERNELS.items()}


def read_launches_by_shape() -> dict:
    """The wrappers' counts by shape: B1 by packed or dense grid and
    candidates of the launch, B2 by image grid and planes, B3 by grid,
    candidates, channels and n_best, B4 by image grid, radius and gap, B5
    by regions and the largest region's points, B6 by kernel, grid and
    banks."""
    def shapes(key):
        return sorted(trace.by_key(f"launches_by_shape.{KERNELS[key]}")
                      .items())
    return {"ncc": [{"grid": [hc, wc], "C": c, "launches": n}
                    for (hc, wc, c), n in shapes("ncc")],
            "warp": [{"grid": [h, w_], "planes": s, "launches": n}
                     for (s, h, w_), n in shapes("warp")],
            "direct": [{"grid": [hc, wc], "C": c, "channels": ch,
                        "n_best": nb, "launches": n}
                       for (hc, wc, c, ch, nb), n in shapes("direct")],
            "wmf": [{"grid": [h, w_], "radius": r, "gap": g, "launches": n}
                    for (h, w_, r, g), n in shapes("wmf")],
            "ransac": [{"regions": r, "largest_n": m, "launches": n}
                       for (r, m), n in shapes("ransac")],
            "halfpass": [{"kernel": k, "grid": [hc, wc], "banks": b,
                          "launches": n}
                         for (k, hc, wc, b), n in shapes("halfpass")]}


# WMF passes a view at the default AlgorithmParams (wmf_iters +
# wmf_final_iters): kernel B4's launches a view.
WMF_PASSES = 4 + 6
# Kernels of any kind (kernels, copies, fills) view 0's pyramid may
# launch on the main path, as the profiler counts them
# (kernel_times.patchmatch_split): B6 brought them from about 23,800 down.
PYRAMID_LAUNCHES = 2000


def run_main_path(scene_gt, root: Path, dev) -> dict:
    """Phase 5."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch import pipeline
    scene = pipeline.load_scene(root)
    stages: dict[str, float] = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = stage_timer(stages)
    reset_launches()
    t0 = time.perf_counter()
    result = pipeline.process_view(scene, 0, AlgorithmParams(), device=dev,
                                   timer=timer)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    by_shape = read_launches_by_shape()
    plain = plain_halfpass_calls()
    peak = torch.cuda.max_memory_allocated()
    from tsar_mvs_tpu_torch.ops import cuda_weak_texture
    b7 = [trace.counter("launches.b7"),
          len(cuda_weak_texture.plan(H, W, 2, AlgorithmParams()
                                     .weak_text_num).kernels),
          trace.counter("weak_texture.plain_calls")]

    pm_acc = acc2_for(scene_gt, scene, 0, result.depth_pm)
    final_acc = acc2_for(scene_gt, scene, 0, result.depth)
    acc = {"acc2_pm": pm_acc["textured"], "acc2_final": final_acc["textured"],
           "acc2_weak_pm": pm_acc["weak"],
           "acc2_weak_final": final_acc["weak"],
           "matchable_frac": pm_acc["matchable_frac"]}
    out = root / "results" / scene.names[0]
    artifacts = ["TSAR_disp.dmb", "TSAR_normals.dmb", "TSAR_model.ply",
                 "TSAR_slic.png", "TSAR_slic_labels.dmb",
                 "TSAR_slic_graph.txt", "TSAR_results.txt"]
    missing = [a for a in artifacts if not (out / a).exists()]
    finite = bool(np.isfinite(result.depth).all()
                  and result.depth.shape == (H, W))
    res = {"seconds": total, "stages": stages, "peak_bytes": peak,
           "launches": launches, "launches_by_shape": by_shape, **acc,
           "plain_halfpass_calls": plain, "missing": missing,
           "depth_finite": finite, "b7_launches_plan_plain": b7}
    print(f"main path: {json.dumps(res)}", flush=True)
    if missing or not finite:
        raise SystemExit(f"main path artifacts: missing {missing}, "
                         f"finite depth {finite}")
    if (min(launches["ncc"], launches["warp"]) == 0 or launches["direct"]
            or launches["wmf"] != WMF_PASSES or launches["ransac"] != 1
            or launches["halfpass"] != b6_expected(scene, AlgorithmParams())
            or plain):
        raise SystemExit(f"the main path launches B1, B2, B4 (once per "
                         f"WMF pass), B5 (once: view 0 has trueweak "
                         f"regions) and B6 (two a half-pass and two a "
                         f"refine scale) only, and no plain half-pass: "
                         f"{launches}, plain {plain}")
    if b7[0] != b7[1] or b7[2]:
        raise SystemExit(f"the weak-texture stage launches B7's plan and "
                         f"never the plain version: launches, plan, plain "
                         f"calls {b7}")
    for kernel, total in launches.items():
        if sum(sh["launches"] for sh in by_shape[kernel]) != total:
            raise SystemExit(f"{kernel}: launches by shape {by_shape} do "
                             f"not add up to {total}")
    if acc["acc2_pm"] < 0.95 or acc["acc2_final"] < 0.95:
        raise SystemExit(f"accuracy below 0.95: {acc}")
    return res


def benchmark_views(config_name: str, dev):
    """The benchmark's views of a configuration (benchmark/scene.py, as
    benchmark/run.py renders them) and its AlgorithmParams keywords."""
    from benchmark import scene as bench_scene
    config = json.loads((Path(__file__).resolve().parent / "benchmark" /
                         "configs" / f"{config_name}.json").read_text())
    W_, H_ = config["resolution"]
    geo = config["scene"]
    sd = bench_scene.make_scene(
        H_, W_, config["images"], geo["texture_seed"], dev,
        weak_fraction=geo["weak_fraction"], arc_radius=geo["arc_radius"],
        arc_span_deg=geo["arc_span_deg"], pair_top_k=config["pair_top_k"])
    return sd.images.cpu().numpy(), config["algorithm"]


def run_b7_phase(dev) -> dict:
    """Phase 5(e): B7 against its plain version, then timed."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    rows, times = [], {}
    for config_name in ("eth3d-2k", "middlebury-dino"):
        images, kw = benchmark_views(config_name, dev)
        for view in range(min(8, len(images))):
            rows.append(kt.check_b7(images[view], AlgorithmParams(**kw), 2,
                                    dev, f"{config_name} view {view}"))
        times[config_name] = kt.time_b7(images[0], AlgorithmParams(**kw),
                                        dev)
        del images
    for name in kt.B7_CASES:
        gray, kw, levels = kt.b7_case(name)
        rows.append(kt.check_b7(gray, AlgorithmParams(**kw), levels, dev,
                                name))
    bad = [r for r in rows if not kt.b7_ok(r)]
    print(f"B7 vs plain (phase 5e): {json.dumps(rows)} -> "
          f"{'equal' if not bad else 'DIFFERENT'}", flush=True)
    print(f"B7 times (phase 5e): {json.dumps(times)}", flush=True)
    if bad:
        raise SystemExit(f"B7 differs from its plain version: {bad}")
    return {"rows": rows, "times": times}


def run_scene_phase(scene_gt, root: Path, dev) -> dict:
    """process_scene (resume: view 0 is phase 5's), fuse_scene, F1@2cm."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch import eval as ev
    from tsar_mvs_tpu_torch.utils import dmb, ply
    from tsar_mvs_tpu_torch.utils.synthetic import gt_cloud
    from tsar_mvs_tpu_torch import pipeline
    scene = pipeline.load_scene(root)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pipeline.process_scene(root, resume=True, device=dev)
    torch.cuda.synchronize()
    views_s = time.perf_counter() - t0
    launches = read_launches()
    b5 = b5_expected(len(scene.names) - 1)
    t0 = time.perf_counter()
    fused = pipeline.fuse_scene(root, device=dev)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0

    per_view_s, acc2_final = [], []
    for ref, name in enumerate(scene.names):
        log = (root / "results" / name / "TSAR_results.txt").read_text()
        per_view_s.append(float(log.split("Total runtime:")[-1].split()[0]))
        depth = dmb.read_dmb(root / "results" / name / "TSAR_disp.dmb")
        acc2_final.append(acc2_for(scene_gt, scene, ref, depth)["textured"])
    pts = ply.read_ply(fused)[0]
    n_points = int(pts.shape[0])
    pts = pts[np.isfinite(pts).all(1) & (np.abs(pts) > 1e-9).any(1)]
    t0 = time.perf_counter()
    fs = ev.point_cloud_fscore(pts, gt_cloud(scene_gt), threshold=0.02)
    res = {"per_view_s": per_view_s, "views_s": views_s,
           "acc2_final": acc2_final, "fuse_s": fuse_s,
           "points": n_points, "f1": fs.f1, "precision": fs.precision,
           "recall": fs.recall, "score_s": time.perf_counter() - t0,
           "launches": launches,
           "views_without_regions": len(scene.names) - 1 - b5}
    print(f"scene phase: {json.dumps(res)}", flush=True)
    if (min(launches["ncc"], launches["warp"]) == 0
            or launches["wmf"] != (len(scene.names) - 1) * WMF_PASSES
            or launches["ransac"] != b5 or b5 == 0
            or launches["halfpass"] != (len(scene.names) - 1) * b6_expected(
                scene, AlgorithmParams()) or plain_halfpass_calls()):
        raise SystemExit(f"a kernel was not launched in the scene (B4 once "
                         f"per WMF pass of views 1-7, B5 once a view with "
                         f"a trueweak region: {b5}): {launches}")
    if fs.f1 < 0.94 or min(acc2_final) < 0.95:
        raise SystemExit(f"scene below its limits: F1 {fs.f1}, "
                         f"acc2_final {acc2_final}")
    return res


# (pm_iterations, svolume_budget_mb, ncc_impl, least acc2_final) of phase
# 7's runs. The default budget leaves view 1's full-resolution volume at
# 18 to 211 planes per source, a maximum epipolar spacing of about 34 px
# against the 2 px design step, and PatchMatch from the prior then falls
# to about 0.71 (0.89 after refinement; NVIDIA H100 80GB HBM3, 700.00 W).
# 16384 MiB narrows the spacing to about 7 px (peak about 19.5 GB). The
# direct sampler has no plane spacing (phase 8(f)); the budget does not
# apply to it.
APD_RUNS = ((0, 4096, "auto", 0.95), (2, 4096, "auto", 0.85),
            (2, 16384, "auto", 0.95), (2, 4096, "direct", 0.95))


def run_apd_phase(scene_gt, root: Path, dev) -> list[dict]:
    """View 1 refined from a noisy GT prior: once as the reference runs
    it (no PatchMatch), then with 2 full-resolution PatchMatch iterations
    from the lifted prior under two s-volume budgets."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.utils import display, dmb
    from tsar_mvs_tpu_torch import pipeline
    scene = pipeline.load_scene(root)
    ref = 1
    rng = np.random.default_rng(1)
    gt = scene_gt.depth[ref]
    prior = gt * (1.0 + 0.005 * rng.standard_normal(gt.shape))
    redraw = rng.random(gt.shape) < 0.05
    prior = np.where(redraw, gt * rng.uniform(0.7, 1.3, gt.shape), prior)
    prior = np.where(np.isfinite(prior), prior, 0.0).astype(np.float32)
    apd = root / "APD" / scene.names[ref]
    apd.mkdir(parents=True, exist_ok=True)
    dmb.write_dmb(apd / "depths_geom.dmb", prior)
    dmb.write_dmb(apd / "normals.dmb",
                  scene_gt.normal_world[ref].astype(np.float32))
    display.write_png(apd / "weak.png",
                      np.where(redraw, 0, 255).astype(np.uint8))
    acc2_prior = acc2_for(scene_gt, scene, ref, prior)["textured"]

    out = []
    for pm_iterations, budget, impl, least in APD_RUNS:
        stages: dict[str, float] = {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = stage_timer(stages)
        reset_launches()
        t0 = time.perf_counter()
        result = pipeline.process_view(
            scene, ref, AlgorithmParams(svolume_budget_mb=budget,
                                        ncc_impl=impl),
            pm_iterations=pm_iterations,
            out_dir=root.parent / f"apd_pm{pm_iterations}_{budget}_{impl}",
            device=dev, timer=timer)
        torch.cuda.synchronize()
        res = {"pm_iterations": pm_iterations, "svolume_budget_mb": budget,
               "ncc_impl": impl,
               "seconds": time.perf_counter() - t0, "stages": stages,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "launches": read_launches(), "acc2_prior": acc2_prior,
               "acc2_pm": acc2_for(scene_gt, scene, ref,
                                   result.depth_pm)["textured"],
               "acc2_final": acc2_for(scene_gt, scene, ref,
                                      result.depth)["textured"],
               "depth_finite": bool(np.isfinite(result.depth).all())}
        print(f"APD prior: {json.dumps(res)}", flush=True)
        if not res["depth_finite"]:
            raise SystemExit("APD branch: non-finite depth")
        la = res["launches"]
        used = ({"direct", "halfpass"} if impl == "direct"
                else {"ncc", "warp", "halfpass"}) if pm_iterations else set()
        used.add("wmf")
        if b5_expected(1):
            used.add("ransac")
        if any((la[k] > 0) != (k in used) for k in la) or \
                la["wmf"] != WMF_PASSES or la["ransac"] != b5_expected(1) \
                or plain_halfpass_calls():
            raise SystemExit(f"the APD branch launched {la}; expected "
                             f"{sorted(used) or 'none'}, no plain half-pass")
        if res["acc2_final"] < least:
            raise SystemExit(f"APD, {pm_iterations} PatchMatch iterations, "
                             f"{budget} MiB, {impl}: acc2_final below "
                             f"{least}: {res['acc2_final']}")
        out.append(res)
    return out


def run_direct_view(scene_gt, scene, params, out_dir: Path, dev,
                    evaluations: int) -> dict:
    """View 0 of `scene` through process_view with `params` on the direct
    sampler: seconds, launches (B3 once per cost evaluation, B1 and B2
    never) and acc2, both >= 0.95 over the pixels seen by at least n_best
    sources. With n_best > 1 a pixel seen by fewer sources averages the
    costs of views that cannot see its surface (the reference's best-n
    mean has no visibility test), so acc2 over every matchable pixel
    (seen by one source or more) is reported beside it, unheld."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch import pipeline
    stages: dict[str, float] = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timer = stage_timer(stages)
    reset_launches()
    t0 = time.perf_counter()
    result = pipeline.process_view(scene, 0, params, out_dir=out_dir,
                                   device=dev, timer=timer)
    torch.cuda.synchronize()
    res = {"seconds": time.perf_counter() - t0, "stages": stages,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": read_launches(),
           "launches_by_shape": read_launches_by_shape()["direct"],
           "acc2_pm": acc2_for(scene_gt, scene, 0, result.depth_pm,
                               params.n_best)["textured"],
           "acc2_final": acc2_for(scene_gt, scene, 0, result.depth,
                                  params.n_best)["textured"],
           "depth_finite": bool(np.isfinite(result.depth).all())}
    if params.n_best > 1:
        res["acc2_pm_seen_by_1"] = acc2_for(scene_gt, scene, 0,
                                            result.depth_pm)["textured"]
        res["acc2_final_seen_by_1"] = acc2_for(scene_gt, scene, 0,
                                               result.depth)["textured"]
    expect = {"ncc": 0, "warp": 0, "direct": evaluations,
              "wmf": WMF_PASSES, "ransac": b5_expected(1),
              "halfpass": b6_expected(scene, params)}
    if res["launches"] != expect or plain_halfpass_calls():
        raise SystemExit(f"direct view: launches {res['launches']}, "
                         f"expected {expect}, plain half-passes "
                         f"{plain_halfpass_calls()}")
    if (not res["depth_finite"] or res["acc2_pm"] < 0.95
            or res["acc2_final"] < 0.95):
        raise SystemExit(f"direct view below its limits: {res}")
    return res


def export_color_scene(scene_gt, root: Path) -> tuple[Path, object]:
    """The scene at `root` with its views as 3-channel PFMs
    (kernel_times.color_from_gray of the rendered gray images); cameras and
    pair.txt copied. Returns the new root and the (V, 3, H, W) colours."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.utils.pfm import write_pfm
    croot = root.parent / "scene_color"
    (croot / "images").mkdir(parents=True, exist_ok=True)
    shutil.copytree(root / "cams", croot / "cams", dirs_exist_ok=True)
    shutil.copy(root / "pair.txt", croot / "pair.txt")
    rgb = kt.color_from_gray(scene_gt.images)
    for v in range(rgb.shape[0]):
        write_pfm(croot / "images" / f"{v:08d}.pfm",
                  rgb[v].transpose(1, 2, 0))
    return croot, rgb


def run_direct_phase(scene_gt, root: Path, dev, evaluations: int) -> dict:
    """Phase 8(c) and 8(d): view 0 on the direct sampler in grayscale,
    with color_processing on the colour export, and with n_best 3."""
    import numpy as np
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.utils import ply
    scene = pipeline.load_scene(root)
    direct = run_direct_view(scene_gt, scene,
                             AlgorithmParams(ncc_impl="direct"),
                             root.parent / "direct_gray", dev, evaluations)
    print(f"direct view (phase 8c): {json.dumps(direct)}", flush=True)
    croot, rgb = export_color_scene(scene_gt, root)
    out = root.parent / "direct_color"
    color = run_direct_view(scene_gt, pipeline.load_scene(croot),
                            AlgorithmParams(color_processing=True), out,
                            dev, evaluations)
    colors = ply.read_ply(out / "TSAR_model.ply")[2]
    color["ply_colors_equal_input"] = bool(np.array_equal(
        colors, rgb[0].transpose(1, 2, 0).reshape(-1, 3).astype(np.uint8)))
    print(f"colour view (phase 8d): {json.dumps(color)}", flush=True)
    if not color["ply_colors_equal_input"]:
        raise SystemExit("the colour view's PLY colours differ from its "
                         "input")
    nbest = run_direct_view(scene_gt, scene, AlgorithmParams(n_best=3),
                            root.parent / "direct_nbest3", dev, evaluations)
    print(f"n_best 3 view (phase 8d): {json.dumps(nbest)}", flush=True)
    return direct


def run_odd_phase(dev) -> dict:
    """Phase 8(e): view 0 of an ODD scene (pyramid level 2 has an odd side)
    and of an EVEN one on both samplers; acc2_pm must agree to 0.02 per
    sampler. Prints one line."""
    import torch
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch import kernel_times as kt
    base = Path(tempfile.mkdtemp(prefix="tsar_odd_"))
    runs, odd_calls = {}, []
    for h, w in (ODD, EVEN):
        t = time.perf_counter()
        sg = make_scene(height=h, width=w, num_views=ODD_VIEWS, seed=0)
        root = sg.export(base / f"scene_{h}x{w}")
        render_s = time.perf_counter() - t
        scene = pipeline.load_scene(root)
        for impl in ("svolume", "direct"):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with (kt.recording_halfpasses(odd_calls)
                  if (h, w) == ODD and impl == "svolume"
                  else contextlib.nullcontext()):
                result = pipeline.process_view(
                    scene, 0, AlgorithmParams(ncc_impl=impl),
                    out_dir=base / f"out_{h}x{w}_{impl}", device=dev)
            torch.cuda.synchronize()
            la = read_launches()
            used = ({"direct"} if impl == "direct" else {"ncc", "warp"}
                    ) | {"wmf", "halfpass"} | (
                        {"ransac"} if b5_expected(1) else set())
            if any((la[k] > 0) != (k in used) for k in la) or \
                    la["wmf"] != WMF_PASSES or \
                    la["ransac"] != b5_expected(1) or \
                    la["halfpass"] != b6_expected(
                        scene, AlgorithmParams(ncc_impl=impl)) or \
                    plain_halfpass_calls():
                raise SystemExit(f"{h}x{w} {impl}: launches {la}, plain "
                                 f"half-passes {plain_halfpass_calls()}")
            runs[f"{h}x{w} {impl}"] = {
                "seconds": time.perf_counter() - t0, "render_s": render_s,
                "launches": la,
                "acc2_pm": acc2_for(sg, scene, 0, result.depth_pm)[
                    "textured"],
                "acc2_final": acc2_for(sg, scene, 0, result.depth)[
                    "textured"]}
    gaps = {impl: abs(runs[f"{ODD[0]}x{ODD[1]} {impl}"]["acc2_pm"]
                      - runs[f"{EVEN[0]}x{EVEN[1]} {impl}"]["acc2_pm"])
            for impl in ("svolume", "direct")}
    ok = max(gaps.values()) <= 0.02
    print(f"odd-sided levels (phase 8e): "
          f"{json.dumps({'runs': runs, 'acc2_pm_gap': gaps})} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    if not ok:
        raise SystemExit(f"odd-sided levels: acc2_pm gaps {gaps} above 0.02")
    dense = [c for c in odd_calls if not c["grid"].packed]
    if not dense:
        raise SystemExit("the odd scene ran no dense half-pass")
    _, b6_worst = check_b6(dense, f"the dense level of {ODD[0]}x{ODD[1]}, "
                                  f"phase 8e")
    return runs, b6_worst


# Phase 9(b): two ranks sharing the card under gloo, on a scene of this
# size and view count, on both samplers.
SHARDED_SMALL, SHARDED_SMALL_VIEWS = (336, 512), 4
SHARDED_IMPLS = ("svolume", "direct")


def copy_scene(root: Path, dest: Path) -> Path:
    """A fresh scene root with `root`'s images/, cams/ and pair.txt (no
    results), so an earlier phase's artifacts stay as they are."""
    dest.mkdir(parents=True)
    for sub in ("images", "cams"):
        shutil.copytree(root / sub, dest / sub)
    shutil.copy(root / "pair.txt", dest / "pair.txt")
    return dest


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_sharded_phase(scene_gt, root: Path, dev, evaluations: int,
                      builds: int, sequential: dict) -> dict:
    """Phase 9(a): process_scene_sharded on a copy of the 2K scene, world 1
    in an NCCL group on `dev`: per-phase seconds, peak memory, launches
    (B1 once per cost evaluation and B2 once per volume of every view, B3
    never), per-view acc2_pm and acc2_final, the fused cloud's F1@2cm
    beside phase 6's sequential points and F1."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tsar_mvs_tpu_torch import eval as ev
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams, FusionParams
    from tsar_mvs_tpu_torch.parallel import mesh as pmesh
    from tsar_mvs_tpu_torch.parallel import scene_sharded
    from tsar_mvs_tpu_torch.utils import ply
    from tsar_mvs_tpu_torch.utils.synthetic import gt_cloud
    sroot = copy_scene(root, root.parent / "scene_sharded")
    scene = pipeline.load_scene(sroot)
    V = len(scene.names)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = pmesh.view_mesh(dev)
        stages: dict[str, float] = {}
        pm_depths: dict[int, object] = {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = stage_timer(stages)
        reset_launches()
        t0 = time.perf_counter()
        depths, _, cloud = scene_sharded.process_scene_sharded(
            scene, AlgorithmParams(), FusionParams(), seed=0, mesh=mesh,
            timer=timer, pm_depths=pm_depths)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        plain = plain_halfpass_calls()
        b5 = b5_expected(V)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    acc2_pm = [acc2_for(scene_gt, scene, r, pm_depths[r])["textured"]
               for r in range(V)]
    acc2_final = [acc2_for(scene_gt, scene, r, depths[r])["textured"]
                  for r in range(V)]
    pts = cloud.points[np.isfinite(cloud.points).all(1)
                       & (np.abs(cloud.points) > 1e-9).any(1)]
    fs = ev.point_cloud_fscore(pts, gt_cloud(scene_gt), threshold=0.02)
    fused = sroot / "results" / "TSAR_fused.ply"
    written = all((sroot / "results" / n / f).exists() for n in scene.names
                  for f in ("TSAR_disp.dmb", "TSAR_normals.dmb"))
    res = {"world": mesh.world, "backend": backend,
           "device": str(mesh.device), "seconds": seconds, "stages": stages,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "acc2_pm": {"min": min(acc2_pm), "mean": float(np.mean(acc2_pm)),
                       "per_view": acc2_pm},
           "acc2_final": {"min": min(acc2_final),
                          "mean": float(np.mean(acc2_final)),
                          "per_view": acc2_final},
           "points": int(cloud.points.shape[0]),
           "ply_points": int(ply.read_ply(fused)[0].shape[0])
           if fused.exists() else None,
           "f1": fs.f1, "precision": fs.precision, "recall": fs.recall,
           "sequential_points": sequential["points"],
           "sequential_f1": sequential["f1"], "artifacts_written": written,
           "views_without_regions": V - b5, "plain_halfpass_calls": plain}
    print(f"sharded scene (phase 9a): {json.dumps(res)}", flush=True)
    expect = {"ncc": V * evaluations, "warp": V * builds, "direct": 0,
              "wmf": V * WMF_PASSES, "ransac": b5,
              "halfpass": V * b6_expected(scene, AlgorithmParams())}
    if launches != expect or res["plain_halfpass_calls"]:
        raise SystemExit(f"sharded scene: launches {launches}, expected "
                         f"{expect}")
    if not written or res["ply_points"] != res["points"]:
        raise SystemExit("sharded scene: artifacts missing or the fused "
                         "PLY disagrees with the cloud")
    if fs.f1 < 0.94 or min(acc2_pm) < 0.95 or min(acc2_final) < 0.95:
        raise SystemExit(f"sharded scene below its limits: F1 {fs.f1}, "
                         f"acc2_pm {acc2_pm}, acc2_final {acc2_final}")
    return res


def site_fields(gt_depth, gt_normal, R, cams, stats, level: int,
                gen) -> list:
    """(field, normal, d, invalid) of 8 candidates a pixel for phase 9(c),
    in the frame of a reference with world rotation R and the true depth
    and world normal maps gt_depth, gt_normal: "smooth", the truth at
    this level with the depth within +-0.5% and the normal within +-1/16
    (as kernel_times.smooth_field perturbs); "random",
    kernel_times.random_field. The last candidate is invalid (d = 0)
    everywhere, the first on 10% of the pixels."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import kernel_times as kt
    C, rays = 8, stats.rays
    Hs, Ws = rays.shape[:2]
    dev = rays.device
    depth = np.asarray(gt_depth, np.float32)[::level, ::level][:Hs, :Ws]
    normal = (np.asarray(gt_normal, np.float32)[::level, ::level][:Hs, :Ws]
              @ np.asarray(R, np.float32).T)
    seen = np.isfinite(depth) & np.isfinite(normal).all(-1)
    depth = np.where(seen, depth, np.float32(np.median(depth[seen])))
    normal = np.where(seen[..., None], normal,
                      np.float32([0.0, 0.0, -1.0]))
    depth = torch.as_tensor(depth, device=dev) * (1.0 + 0.005 * (
        2.0 * torch.rand((C, Hs, Ws), generator=gen, device=dev) - 1.0))
    dn = (2.0 * torch.rand((C, Hs, Ws, 3), generator=gen, device=dev)
          - 1.0) / 16.0
    n = geo.hemisphere_flip(
        geo.normalize(torch.as_tensor(normal, device=dev) + dn),
        geo.view_vectors(cams, Hs, Ws))
    lv = {"cams": cams, "stats": stats, "imgs": rays[None, ..., 0]}
    out = []
    for field, (n, d) in (("smooth", (n, geo.plane_d_from_depth(n, rays,
                                                                depth))),
                          ("random", kt.random_field(lv, C, gen))):
        invalid = torch.zeros((C, Hs, Ws), dtype=torch.bool, device=dev)
        invalid[-1] = True
        invalid[0] = torch.rand((Hs, Ws), generator=gen, device=dev) < 0.1
        out.append((field, n, torch.where(invalid, 0.0, d), invalid))
    return out


def check_batch_sites(scene, scene_gt, dev, cut: int, label: str) -> dict:
    """Phase 9(c): the batched runner's call sites of B1, B2 and B3
    (models/patchmatch.py batch_sampler and make_batch_cost_fn) against
    the kernels' plain versions on the same inputs, at every pyramid level
    of process_scene_sharded on `scene`, with the inputs that path gives
    them (parallel/mesh.py pyramid_level_inputs: the warp factors scaled
    to the level, the plane counts shared over the full batch). One
    reference a level, the first to the last; at level index `cut` its
    source list loses its last source, so its row has a padding slot that
    the view tables must drop. Per level and sampler: the views are the
    valid slots' image ids, each volume has its slot's shared plane count
    and meets phase 3's bounds against build_svolume_view_plain
    (kernel_times.b2_agreement); the cost function on site_fields meets
    phase 4's bounds against multiview_cost_plain on the site's volumes,
    or phase 8(a)'s against multiview_cost_direct_plain on its views (the smooth
    field on both parities and dense, the random one on parity 0); one
    launch a volume and one a cost evaluation. Prints one line; returns
    the largest |delta| of each kernel by wrapper key."""
    import dataclasses
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    from tsar_mvs_tpu_torch.ops import cuda_direct, cuda_ncc, cuda_warp, ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    from tsar_mvs_tpu_torch.parallel import mesh as pmesh
    from tsar_mvs_tpu_torch.parallel import scene_sharded
    t0 = time.perf_counter()
    params = pipeline.default_params_for_scene(scene, AlgorithmParams())
    V, H = len(scene.names), scene.images.shape[1]
    levels = pipeline.pyramid_levels_for(H)
    refs = [li * (V - 1) // max(1, len(levels) - 1)
            for li in range(len(levels))]
    batch = scene_sharded.scene_batch(scene, params, dev)
    imgs = torch.as_tensor(scene.images, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    cases, ok_all = [], True
    worst = {"ncc": 0.0, "warp": 0.0, "direct": 0.0}
    for lv in pmesh.pyramid_level_inputs(imgs, batch, params, levels,
                                         list(scene.P), scene.depth_min,
                                         scene.depth_max):
        level, r = levels[lv.index], refs[lv.index]
        row = pmesh.batch_rows(lv.batch, slice(r, r + 1))
        if lv.index == cut:
            srcs = batch.src_ids[r][batch.src_valid[r]].tolist()
            row = pm.build_scene_batch(list(scene.P), [r], [srcs[:-1]],
                                       batch.src_ids.shape[1], device=dev)
            if level != 1:
                row = pmesh.scale_batch(row, float(level))
        src_ids, valid, A, b = (x[0] for x in row[1:])
        keep = torch.nonzero(valid.cpu()).reshape(-1).tolist()
        Hs, Ws = lv.imgs.shape[1:]
        stats = ncc.precompute_ref_stats(lv.imgs[r], lv.cams, lv.params)
        R = geo.decompose_projection(np.asarray(scene.P[r], np.float64))[1]
        fields = site_fields(scene_gt.depth[r], scene_gt.normal_world[r], R,
                             lv.cams, stats, level, gen)
        for impl in ("svolume", "direct"):
            params_i = dataclasses.replace(lv.params, ncc_impl=impl)
            before = read_launches()
            sampler, ids = pm.batch_sampler(lv.imgs, src_ids, valid, A, b,
                                            params_i, lv.svol_planes)
            torch.cuda.synchronize()
            builds = read_launches()["warp"] - before["warp"]
            case = {"level": level, "ref": r, "impl": impl,
                    "slots": int(valid.numel()), "ids": ids.tolist(),
                    "volume_launches": builds}
            ok = case["ids"] == src_ids[keep].tolist()
            if impl == "svolume":
                s_lo, s_hi = sv.s_range_for_depths(
                    params_i.depth_min, params_i.depth_max,
                    params_i.svolume_margin)
                case["planes"] = [int(v.shape[0]) for v in sampler.data]
                ok &= (case["planes"] == [lv.svol_planes[k] for k in keep]
                       and builds == len(keep))
                case["b2"] = []
                for k, slot in enumerate(keep):
                    S = case["planes"][k]
                    plain = cuda_warp.build_svolume_view_plain(
                        lv.imgs[ids[k]], A[slot], b[slot], s_lo,
                        (s_hi - s_lo) / (S - 1), S)
                    b2 = kt.b2_agreement(sampler.data[k], plain)
                    del plain
                    case["b2"].append(b2)
                    ok &= b2["pass"]
                    worst["warp"] = max(worst["warp"], b2["max"])
            else:
                ok &= builds == 0
            cost_fn, pctx = pm.make_batch_cost_fn(stats, lv.cams, Hs, Ws,
                                                  sampler, ids, params_i)
            key = "ncc" if impl == "svolume" else "direct"
            case["evaluations"] = []
            for field, n, d, invalid in fields:
                for parity in ((0, 1, None) if field == "smooth" else (0,)):
                    st, n_p, d_p, inv_p = stats, n, d, invalid
                    if parity is not None:
                        st = ncc.compress_stats(stats, parity)
                        n_p = cb.parity_compress_vec(n, parity)
                        d_p = cb.parity_compress(d, parity)
                        inv_p = cb.parity_compress(invalid, parity)
                    before = read_launches()
                    mk = cost_fn(n_p, d_p, parity)
                    torch.cuda.synchronize()
                    launched = {k: v - before[k]
                                for k, v in read_launches().items()}
                    s0, sx, sy = ncc.plane_scalars(n_p, d_p, st)
                    if impl == "svolume":
                        mp = cuda_ncc.multiview_cost_plain(
                            sampler.data, sampler.s_lo, sampler.inv_ds, ids,
                            s0, sx, sy, st, params_i, parity)
                        agree, good = b1_agreement(mk, mp, inv_p, params_i)
                    else:
                        mp = cuda_direct.multiview_cost_direct_plain(
                            sampler, s0, sx, sy, st, params_i, parity)
                        agree, good = b3_agreement(mk, mp, inv_p, params_i)
                    good &= launched == {**{k: 0 for k in launched},
                                         key: 1}
                    worst[key] = max(worst[key], agree["max"])
                    case["evaluations"].append(
                        {"field": field, "parity": parity,
                         "launches": launched, **agree, "pass": good})
                    ok &= good
                    del mk, mp, s0, sx, sy
            case["pass"] = ok
            ok_all &= ok
            cases.append(case)
            del sampler, cost_fn, pctx
            torch.cuda.empty_cache()
    res = {"scene": label, "seconds": time.perf_counter() - t0,
           "worst": worst, "cases": cases}
    print(f"batch call sites (phase 9c, {label}): {json.dumps(res)} -> "
          f"{'PASS' if ok_all else 'FAIL'}", flush=True)
    if not ok_all:
        raise SystemExit(f"the batched runner's kernel call sites disagree "
                         f"with the plain versions on {label}")
    return worst


def sharded_rank(root: str, out: str) -> None:
    """One rank of phase 9(b), in a gloo group of ranks sharing the card:
    the scene on both samplers; rank 0 saves the results, every rank its
    device and launches."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.parallel import mesh as pmesh
    from tsar_mvs_tpu_torch.parallel import scene_sharded
    mesh = pmesh.view_mesh("cuda")
    if mesh.device.type != "cuda":
        raise SystemExit(f"rank {mesh.rank} runs on {mesh.device}")
    scene = pipeline.load_scene(root)
    info = {"rank": mesh.rank, "world": mesh.world,
            "device": str(mesh.device), "launches": {},
            "views_without_regions": {}}
    for impl in SHARDED_IMPLS:
        reset_launches()
        depths, normals, cloud = scene_sharded.process_scene_sharded(
            scene, AlgorithmParams(ncc_impl=impl), seed=0, mesh=mesh,
            write_artifacts=False)
        torch.cuda.synchronize()
        info["launches"][impl] = read_launches()
        info["launches"][impl]["plain_halfpass"] = plain_halfpass_calls()
        info["views_without_regions"][impl] = trace.counter(
            "ransac.views_without_regions")
        if mesh.rank == 0:
            np.savez(Path(out) / f"{impl}.npz", depths=depths,
                     normals=normals, points=cloud.points)
    (Path(out) / f"rank{mesh.rank}.json").write_text(json.dumps(info))


def run_sharded_ranks_phase(dev) -> dict:
    """Phase 9(b): two ranks sharing the card in a gloo group against world
    1 on the card, at SHARDED_SMALL, on both samplers: depths and normals
    bit-equal and the fused point counts equal; every rank on cuda and
    launching the sampler's kernels (B1 and B2, or B3), and B5 once a view
    with a trueweak region over the ranks."""
    import numpy as np
    import torch
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.parallel import distributed
    from tsar_mvs_tpu_torch.parallel import mesh as pmesh
    from tsar_mvs_tpu_torch.parallel import scene_sharded
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    base = Path(tempfile.mkdtemp(prefix="tsar_sharded_"))
    h, w = SHARDED_SMALL
    sg = make_scene(height=h, width=w, num_views=SHARDED_SMALL_VIEWS, seed=0)
    root = sg.export(base / "scene")
    scene = pipeline.load_scene(root)
    world1 = {}
    for impl in SHARDED_IMPLS:
        t0 = time.perf_counter()
        depths, normals, cloud = scene_sharded.process_scene_sharded(
            scene, AlgorithmParams(ncc_impl=impl), seed=0,
            mesh=pmesh.view_mesh(dev), write_artifacts=False)
        torch.cuda.synchronize()
        world1[impl] = (depths, normals, cloud.points,
                        time.perf_counter() - t0)
    site_worst = check_batch_sites(scene, sg, dev, 1,
                                   f"{h}x{w}x{SHARDED_SMALL_VIEWS}")
    out = base / "ranks"
    out.mkdir()
    t0 = time.perf_counter()
    distributed.run_ranks(sharded_rank, 2, f"file://{base}/pg", "gloo",
                          (str(root), str(out)))
    ranks_s = time.perf_counter() - t0
    infos = [json.loads((out / f"rank{k}.json").read_text())
             for k in range(2)]
    used = {"svolume": {"ncc", "warp", "wmf", "halfpass"},
            "direct": {"direct", "wmf", "halfpass"}}
    res, ok = {"ranks": infos, "ranks_s": ranks_s,
               "site_worst": site_worst}, True
    for impl in SHARDED_IMPLS:
        got = np.load(out / f"{impl}.npz")
        d1, n1, p1, s1 = world1[impl]
        d2 = got["depths"]
        rel = np.abs(d2 - d1) / np.maximum(np.abs(d1), 1e-12)
        r = {"world1_s": s1, "depths_bit_equal": bool(np.array_equal(d1,
                                                                     d2)),
             "normals_bit_equal": bool(np.array_equal(n1, got["normals"])),
             "depth_within_1e-4": float((rel <= 1e-4).mean()),
             "points_world1": int(p1.shape[0]),
             "points_world2": int(got["points"].shape[0]),
             "points_bit_equal": bool(np.array_equal(p1, got["points"]))}
        launched = all((info["launches"][impl][k] > 0) == (k in used[impl])
                       for info in infos for k in info["launches"][impl]
                       if k != "ransac")
        # B6 two a half-pass and two a refine scale of every view, over
        # the ranks.
        launched &= sum(info["launches"][impl]["halfpass"]
                        for info in infos) == SHARDED_SMALL_VIEWS * \
            b6_expected(scene, AlgorithmParams(ncc_impl=impl))
        # B5 once a view over the ranks, less the views without a
        # trueweak region of 3 reliable points (at this size every view
        # has none, so B5 launches nothing here).
        launched &= sum(info["launches"][impl]["ransac"]
                        + info["views_without_regions"][impl]
                        for info in infos) == SHARDED_SMALL_VIEWS
        r["kernels_launched_by_every_rank"] = launched
        ok &= (launched and r["depths_bit_equal"] and r["normals_bit_equal"]
               and r["points_world1"] == r["points_world2"])
        res[impl] = r
    ok &= all(info["device"].startswith("cuda") for info in infos)
    print(f"two ranks on the card (phase 9b): {json.dumps(res)} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    if not ok:
        raise SystemExit("two ranks on the card disagree with world 1")
    return res


# Phase 10: timed views of the bench and of the sampler A/B, each after
# one warm-up run.
BENCH_REPEATS, AB_REPEATS = 2, 2
# The JAX package's acc2_weak_final of the bench on this scene (TPU v5e,
# BENCH_r05.json), printed beside the port's.
ACC2_WEAK_FINAL_TPU = 1.0


def run_harness_phase(scene_gt, dev, evaluations: int, builds: int,
                      b6: int) -> dict:
    """Phase 10: the bench, the sampler A/B and one scaling point on the
    rendered 2K scene (no new render, no subprocess that renders)."""
    import math
    import torch
    from tsar_mvs_tpu_torch import bench, bench_patchmatch, bench_scaling
    t_phase = time.perf_counter()
    views = 1 + BENCH_REPEATS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    launches: dict = {}
    res = bench.run(scene_gt, iters=8, repeats=BENCH_REPEATS,
                    ncc_impl="auto", small=False, device=dev,
                    after_views=lambda: launches.update(read_launches()))
    print(f"bench (phase 10a): {json.dumps(res)}", flush=True)
    expect = {"ncc": views * evaluations, "warp": views * builds,
              "direct": 0, "wmf": views * WMF_PASSES,
              "ransac": b5_expected(views), "halfpass": views * b6}
    bench_s = time.perf_counter() - t_phase
    info = {"seconds": bench_s, "views": views, "launches": launches,
            "expected": expect, "acc2_weak_final": res["acc2_weak_final"],
            "acc2_weak_final_tpu_v5e": ACC2_WEAK_FINAL_TPU}
    print(f"bench (phase 10a): {json.dumps(info)}", flush=True)
    if launches != expect:
        raise SystemExit(f"bench: launches {launches}, expected {expect} "
                         f"(one per evaluation and volume in each of "
                         f"{views} views)")
    if (res["acc2_pm"] < 0.95 or res["acc2_final"] < 0.95
            or not res["cuda_crosscheck"].startswith("ok")
            or "B4 0" not in res["cuda_crosscheck"]):
        raise SystemExit(f"bench below its limits: {res}")
    # The crosscheck a TSAR_NCC_IMPL=direct bench makes: B3 too, exact.
    check = bench.cuda_crosscheck(
        scene_gt, bench.bench_params(scene_gt, 8, "direct", False), dev)
    print(f"bench crosscheck on the direct sampler (phase 10a): {check}",
          flush=True)
    if not check.startswith("ok") or "B3 0" not in check or \
            "B4 0" not in check:
        raise SystemExit(f"bench crosscheck on the direct sampler: {check}")

    t = time.perf_counter()
    runs = 1 + AB_REPEATS
    ab, ab_launches = [], {}
    for impl in ("direct", "svolume"):
        reset_launches()
        ab += bench_patchmatch.run(scene_gt, [impl], iters=8,
                                   repeats=AB_REPEATS, device=dev)
        ab_launches[impl] = read_launches()
    ab_s = time.perf_counter() - t
    info = {"seconds": ab_s, "launches": ab_launches}
    print(f"sampler A/B (phase 10b): {json.dumps(info)}", flush=True)
    if any("error" in r or r["acc2_pm"] < 0.95 for r in ab):
        raise SystemExit(f"sampler A/B below its limits: {ab}")
    if ab_launches != {
            "direct": {"ncc": 0, "warp": 0, "direct": runs * evaluations,
                       "wmf": 0, "ransac": 0, "halfpass": runs * b6},
            "svolume": {"ncc": runs * evaluations, "warp": runs * builds,
                        "direct": 0, "wmf": 0, "ransac": 0,
                        "halfpass": runs * b6}}:
        raise SystemExit(f"sampler A/B launches {ab_launches}")

    t = time.perf_counter()
    scale = bench_scaling.run_count(1)
    scale_s = time.perf_counter() - t
    print(f"scaling (phase 10c): {json.dumps(bench_scaling.record(scale))}",
          flush=True)
    if not (scale["wall_s"] > 0 and math.isfinite(scale["cost_sum"])):
        raise SystemExit(f"scaling point: {scale}")
    out = {"bench_s": bench_s, "ab_s": ab_s, "scaling_s": scale_s,
           "scaling_cost_sum": scale["cost_sum"],
           "seconds": time.perf_counter() - t_phase}
    print(f"harnesses (phase 10): {json.dumps(out)}", flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    from tsar_mvs_tpu_torch import _build, pipeline
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.ops import cuda_direct
    from tsar_mvs_tpu_torch.utils import native

    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    card = kt.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t
    print(f"build: {build_s:.2f} s ({_build.library_path().name}), "
          f"seconds to each source's end {json.dumps(_build.BUILD_SECONDS)}; "
          f"{' | '.join(_build.kernel_resources())}", flush=True)
    b3_instances = cuda_direct.kernel_attributes()
    print(f"B3 instances (cudaFuncGetAttributes): "
          f"{json.dumps(b3_instances)}", flush=True)
    # Which path the weak_texture stage's seconds belong to.
    host_lib = ("loaded" if native.load() is not None
                else "not available, numpy and scipy run instead")
    print(f"host library (native/): {host_lib}", flush=True)

    t = time.perf_counter()
    scene_gt = make_scene(height=H, width=W, num_views=VIEWS, seed=0,
                          workers=VIEWS)
    root = Path(tempfile.mkdtemp(prefix="tsar_smoke_")) / "scene"
    scene_gt.export(root)
    scene = pipeline.load_scene(root)
    params = pipeline.default_params_for_scene(scene, AlgorithmParams())
    print(f"scene: {H}x{W}x{VIEWS} in {time.perf_counter() - t:.1f} s",
          flush=True)

    gt = {"depth": scene_gt.depth[0],
          "normal_world": scene_gt.normal_world[0]}
    warp = check_warp(scene, params, dev)
    b1_shapes, b2_shapes, b3_shapes, ncc_worst = [], [], [], 0.0
    for li in range(len(kt.LEVELS)):
        lv = kt.level_inputs(scene, params, li, dev)
        b2_shapes.append(kt.time_b2_level(lv))
        if lv["level"] == 2:
            ncc_worst = check_ncc(lv, gt)
            direct_worst = check_direct(lv, gt)
        b1_shapes.extend(kt.time_b1_level(lv, gt))
        b3_shapes.extend(kt.time_b3_level(lv, gt))
        if lv["level"] == 1:
            b1_windows = kt.time_b1_windows(lv, gt)
        del lv
        torch.cuda.empty_cache()
    print(f"B3 shapes (phase 8b): {json.dumps(b3_shapes)}", flush=True)
    print(f"elapsed after the kernel phases: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    for sh in b1_shapes:
        if (sh["max_abs_err"] > 1e-3 or sh["ratio_max_abs_err"] > 1e-3
                or sh["best_view_mismatches"]):
            raise SystemExit(f"B1 disagrees with its plain version at "
                             f"{sh}")
    for sh in b1_windows:
        if (sh["max_abs_err"] > 1e-3 or sh["ratio_max_abs_err"] > 1e-3
                or sh["best_view_mismatches"]):
            raise SystemExit(f"B1 disagrees with its plain version at "
                             f"{sh}")
    for sh in b2_shapes:
        if sh["max_abs_err"] > 2.0:
            raise SystemExit(f"B2 disagrees with its plain version at {sh}")
    for sh in b3_shapes:
        if (sh["max_abs_err"] != 0.0 or sh["ratio_max_abs_err"] != 0.0
                or sh["best_view_mismatches"]):
            raise SystemExit(f"B3 disagrees with its plain version at "
                             f"{sh}")
    main_res = run_main_path(scene_gt, root, dev)
    calls = kt.view_inputs(scene, AlgorithmParams(), dev, halfpass=True)
    b4_shapes, b4_worst = check_b4(calls["wmf"])
    b5_shapes, b5_worst = check_b5(calls["ransac"])
    b6_rows, b6_worst = check_b6(calls["halfpass"], "view 0's levels, "
                                                     "phase 5d")
    b6_shapes = kt.time_b6(calls["halfpass"], {
        (r["kernel"], *r["grid"], r["banks"]): r["launches"]
        for r in main_res["launches_by_shape"]["halfpass"]})
    del calls
    torch.cuda.empty_cache()
    b7_res = run_b7_phase(dev)
    torch.cuda.empty_cache()
    plan = kt.launch_plan(scene, params)
    evaluations = sum(p["propagation"] + p["refinement"] + p["init"]
                      for p in plan)
    builds = sum(p["builds"] for p in plan)
    b6 = kt.b6_launches(plan)
    print(f"launch plan: {json.dumps(plan)}", flush=True)
    if main_res["launches"] != {"ncc": evaluations, "warp": builds,
                                "direct": 0, "wmf": WMF_PASSES,
                                "ransac": 1, "halfpass": b6}:
        raise SystemExit(f"launches {main_res['launches']} are not one per "
                         f"cost evaluation ({evaluations}), one per "
                         f"volume ({builds}) and B6's {b6}")
    torch.cuda.empty_cache()
    split = kt.patchmatch_split(scene, params, dev)
    if split["device"] is None:
        raise SystemExit("the profiler reported no device activity")
    dev_split = split["device"]
    if (dev_split["b1"]["launches"] != evaluations
            or dev_split["b2"]["launches"] != builds
            or dev_split["b6"]["launches"] != b6
            or split["launches"] >= PYRAMID_LAUNCHES):
        raise SystemExit(f"view 0's pyramid launched {split['launches']} "
                         f"kernels of any kind (at most "
                         f"{PYRAMID_LAUNCHES - 1}), B1, B2 and B6 "
                         f"{dev_split['b1']['launches']}, "
                         f"{dev_split['b2']['launches']}, "
                         f"{dev_split['b6']['launches']} (expected "
                         f"{evaluations}, {builds}, {b6})")
    by_kind = kt.b1_seconds_by_kind(plan, split["b1_each_us"])
    print(f"B1 on the main path, [seconds, launches] by level and kind: "
          f"{json.dumps(by_kind)}", flush=True)
    direct_split = kt.direct_splits(scene, params, dev)
    print(f"PatchMatch on the direct paths (B3 split): "
          f"{json.dumps(direct_split)}", flush=True)
    for name, sp in direct_split.items():
        if sp["device"] is None or sp["device"]["b3"]["launches"] != \
                evaluations:
            raise SystemExit(f"direct path {name}: B3 not launched once per "
                             f"evaluation ({evaluations}): {sp}")
    torch.cuda.empty_cache()
    scene_res = run_scene_phase(scene_gt, root, dev)
    torch.cuda.empty_cache()
    run_apd_phase(scene_gt, root, dev)
    torch.cuda.empty_cache()
    direct_res = run_direct_phase(scene_gt, root, dev, evaluations)
    torch.cuda.empty_cache()
    _, odd_b6_worst = run_odd_phase(dev)
    torch.cuda.empty_cache()
    run_sharded_phase(scene_gt, root, dev, evaluations, builds, scene_res)
    torch.cuda.empty_cache()
    site_worst = [check_batch_sites(pipeline.load_scene(root), scene_gt, dev,
                                    1, f"{H}x{W}x{VIEWS}")]
    torch.cuda.empty_cache()
    site_worst.append(run_sharded_ranks_phase(dev)["site_worst"])
    torch.cuda.empty_cache()
    run_harness_phase(scene_gt, dev, evaluations, builds, b6)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    head_b1 = next(sh for sh in b1_shapes if sh["level"] == 1
                   and sh["C"] == 1 and sh["field"] == "smooth")
    head_b2 = next(sh for sh in b2_shapes if sh["level"] == 1)
    # B4's passes take the same time within a few percent; the first is
    # the widest marking pass.
    head_b4 = {**b4_shapes[0], "library_ms": None}
    head_b5 = {**b5_shapes[0], "library_ms": None}
    # B6's numbers: its four kernels at level 1 (1344x1024 packed, 4
    # banks), one of each: a propagation half-pass's select and accept and
    # a refine scale's propose and accept. "ms" holds the wrapper's host
    # time between back-to-back launches, "device_ms" the kernels' own.
    # A sum is null when any of its readings is (a dropped trace).
    level1 = [sh for sh in b6_shapes if sh["grid"] == [H, W // 2]]
    head_b6 = {k: (None if any(sh[k] is None for sh in level1)
                   else sum(sh[k] for sh in level1))
               for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    head_b6.update(bound_by="bytes" if all(sh["bound_by"] == "bytes"
                                           for sh in level1)
                   else "operations", library_ms=None)
    head_b3 = next(sh for sh in b3_shapes if sh["level"] == 1
                   and sh["C"] == 1 and sh["field"] == "smooth"
                   and sh["n_best"] == 1 and sh["channels"] == 1)
    kernels = [
        {"name": "svol_ncc_multiview", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/ncc.cu",
         "replaces": "tsar_mvs_tpu/ops/pallas_ncc.py:117",
         "launches": main_res["launches"]["ncc"],
         "max_abs_err": max(ncc_worst, *(w["ncc"] for w in site_worst),
                            max(sh["max_abs_err"] for sh in b1_shapes)),
         **{k: head_b1[k] for k in keys}, "shapes": b1_shapes,
         "windows": b1_windows,
         "launches_by_shape": main_res["launches_by_shape"]["ncc"]},
        {"name": "warp_build", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/warp.cu",
         "replaces": "tsar_mvs_tpu/ops/pallas_warp.py:155",
         "launches": main_res["launches"]["warp"],
         "max_abs_err": max(warp["max"], *(w["warp"] for w in site_worst),
                            max(sh["max_abs_err"] for sh in b2_shapes)),
         **{k: head_b2[k] for k in keys}, "shapes": b2_shapes,
         "launches_by_shape": main_res["launches_by_shape"]["warp"]},
        {"name": "direct_multiview", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/direct.cu",
         "replaces": "tsar_mvs_tpu/ops/ncc.py:130 (XLA; with "
                     "tsar_mvs_tpu/ops/ncc_color.py:111)",
         "launches": direct_res["launches"]["direct"],
         "max_abs_err": max(direct_worst,
                            *(w["direct"] for w in site_worst),
                            max(sh["max_abs_err"] for sh in b3_shapes)),
         **{k: head_b3[k] for k in keys}, "shapes": b3_shapes,
         "launches_by_shape": direct_res["launches_by_shape"],
         "direct_paths": direct_split,
         "instances": b3_instances,
         "instances_launched": sorted(
             list(k) for k in trace.by_key("launches_by_instance.b3")),
         "build_seconds": _build.BUILD_SECONDS},
        {"name": "wmf_median", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/wmf.cu",
         "replaces": "tsar_mvs_tpu/ops/wmf.py:76 (XLA; _gather_samples "
                     ":136, _median_plane :159)",
         "launches": main_res["launches"]["wmf"],
         "max_abs_err": b4_worst,
         **{k: head_b4[k] for k in keys}, "shapes": b4_shapes,
         "launches_by_shape": main_res["launches_by_shape"]["wmf"]},
        {"name": "ransac_regions", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/ransac.cu",
         "replaces": "tsar_mvs_tpu/models/ransac.py:63 (XLA; "
                     "_plane_from_triplet :37, _count_inliers :51, scans "
                     ":112 and :137; the region loop of "
                     "tsar_mvs_tpu/models/tsar.py:89)",
         "launches": main_res["launches"]["ransac"],
         "max_abs_err": b5_worst,
         **{k: head_b5[k] for k in keys},
         "ceiling_ms": head_b5["ceiling_ms"],
         "chain_ms": head_b5["chain_ms"],
         "rounds_ms": head_b5["rounds_ms"],
         "anneal_ms": head_b5["anneal_ms"], "shapes": b5_shapes,
         "launches_by_shape": main_res["launches_by_shape"]["ransac"]},
        {"name": "checkerboard_halfpass", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/halfpass.cu",
         "replaces": "tsar_mvs_tpu/models/patchmatch.py:258 (XLA; "
                     "_refinement_pass :347 and its scale_body :397, "
                     "make_patchmatch_step :470; "
                     "tsar_mvs_tpu/ops/checkerboard.py:96 "
                     "select_candidates, parity_compress :164, "
                     "parity_expand :173)",
         "launches": main_res["launches"]["halfpass"],
         "max_abs_err": max(b6_worst, odd_b6_worst),
         **{k: head_b6[k] for k in keys},
         "device_ms": head_b6["device_ms"], "shapes": b6_shapes,
         "checks": b6_rows,
         "launches_by_shape": main_res["launches_by_shape"]["halfpass"],
         "pyramid_launches": split["launches"]},
        {"name": "weak_texture", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/weak_texture.cu",
         "replaces": "none: a host stage in the JAX package "
                     "(tsar_mvs_tpu/models/weak_texture.py, numpy and "
                     "scipy)",
         "launches": main_res["b7_launches_plan_plain"][0],
         "max_abs_err": max(sum(v for v in r["mismatch"].values()
                                if isinstance(v, int))
                            for r in b7_res["rows"]),
         **{k: b7_res["times"]["eth3d-2k"][k] for k in keys
            if k != "library_ms"},
         "library_ms": None,
         "device_ms": b7_res["times"]["eth3d-2k"]["device_ms"],
         "times": b7_res["times"], "checks": b7_res["rows"]},
    ]
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
