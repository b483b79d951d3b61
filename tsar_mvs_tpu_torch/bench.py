"""The one-view benchmark of the port (counterpart of the root ``bench.py``):
depth maps per second on an ETH3D-2K-scale synthetic scene.

    python -m tsar_mvs_tpu_torch.bench [--device cuda|cpu]
    python -m tsar_mvs_tpu_torch.cli bench [--device cuda|cpu]

Runs the per-view pipeline at the reference scripts' full operating point
(1344x2048, 7 source views, 8 iterations) in `bench.py`'s stage sequence:
weak texture, SLIC, the coarse-to-fine PatchMatch pyramid, confidence,
coarse WMF outlier marking, region RANSAC, the textureless fill (without
the border check), fine WMF hole filling, finalize. One warm-up view, then
the fastest of REPEATS views; prints ONE JSON line with `bench.py`'s keys:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "stages": {...}, "acc2_pm": ..., ..., "cuda_crosscheck": ...}

`stages` holds each stage's seconds between device synchronisations.
`cuda_crosscheck` holds kernels B1 and B2 (and B3 when the sampler is the
direct one) against their plain versions at one full-resolution shape,
and kernel B4 against its plain version on one full-size WMF pass;
when it fails the line says "FAILED: ..." and the run exits 1.

Environment: TSAR_BENCH_H/W/VIEWS/ITERS/REPEATS (1344/2048/8/8/2),
TSAR_BENCH_SMALL=1 (160x224x4, 2 iterations, 2 + 2 WMF passes; sizes only,
the device is --device's), TSAR_NCC_IMPL=auto|direct|svolume (pallas runs
as svolume), TSAR_BENCH_DIAG=1 (prints the accuracy after each refinement
stage instead), TSAR_BENCH_PROFILE=<dir> (a torch.profiler trace of one
view, <dir>/trace.json). `--device` defaults to cuda; without a card the
run exits 1 unless `--device cpu` is given.

Baseline: the reference publishes no timing tables; its per-view time on
a GTX 980 at this operating point is on the order of 20 s, so 0.05 depth
maps/s, scaled by pixels and source views (`vs_baseline`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch import pipeline
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.models import tsar
from tsar_mvs_tpu_torch.models import weak_texture as wt
from tsar_mvs_tpu_torch.ops import wmf
from tsar_mvs_tpu_torch.utils.synthetic import source_coverage

# Seed offset of the RANSAC generator (the JAX bench's fold_in(key, 99)).
RANSAC_STREAM = 99


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cameras(scene_gt, dev) -> geo.CameraSet:
    """The scene's cameras in view order, view 0 the reference."""
    return geo.build_camera_set(list(scene_gt.P),
                                depth_min=scene_gt.depth_min,
                                depth_max=scene_gt.depth_max, device=dev)


def bench_params(scene_gt, iters: int, ncc_impl: str,
                 small: bool) -> AlgorithmParams:
    """The bench's parameters: `iters` iterations, the sampler (JAX's
    "pallas" maps to "svolume", as convert maps it), 4 coarse and 6 fine
    WMF passes (2 and 2 when small), the scene's depth range."""
    params = convert.algorithm_params(AlgorithmParams(
        iterations=iters, ncc_impl=ncc_impl, wmf_iters=2 if small else 4,
        wmf_final_iters=2 if small else 6))
    return params.with_depth_range(scene_gt.depth_min, scene_gt.depth_max,
                                   float(cameras(scene_gt, "cpu").f))


def one_view(scene_gt, params: AlgorithmParams,
             generator: torch.Generator, stages: dict | None = None,
             diag: dict | None = None):
    """View 0 of `scene_gt` (a utils.synthetic scene) through the bench's
    stage sequence on the generator's device; every other view is a
    source. `stages` accumulates each stage's seconds, each ended by a
    device synchronisation. `diag` (TSAR_BENCH_DIAG) receives the
    reliability masks and depth maps after the marking, the fill and each
    fine WMF pass. Returns (PatchMatch state, final depth, world normals,
    final reliability), all on the device."""
    dev = generator.device
    cams = cameras(scene_gt, dev)
    imgs = torch.as_tensor(scene_gt.images, dtype=torch.float32, device=dev)
    H, W = imgs.shape[1:]
    view_ids = tuple(range(1, imgs.shape[0]))
    t0 = [time.perf_counter()]

    def mark(name):
        sync(dev)
        now = time.perf_counter()
        if stages is not None:
            stages[name] = stages.get(name, 0.0) + now - t0[0]
        t0[0] = now

    weak = wt.detect_weak_texture(scene_gt.images[0], params)
    mark("weak_texture")
    pipeline.run_slic_stage(scene_gt.images[0], params, dev)
    mark("slic")
    levels = pipeline.pyramid_levels_for(H)
    state = pm.run_patchmatch_pyramid(
        generator, imgs, view_ids, list(scene_gt.P), params, levels=levels,
        iterations_per_level=pm.iteration_schedule(params, len(levels)),
        depth_min=scene_gt.depth_min, depth_max=scene_gt.depth_max)
    mark("patchmatch")
    _, _, disp = tsar.confidence_stage(imgs, view_ids, cams, state, params)
    mark("confidence")
    reliable = tsar.wmf_stage(imgs[0], cams, state, disp,
                              torch.ones(disp.shape, dtype=torch.bool,
                                         device=dev),
                              params, iters=params.wmf_iters)
    mark("wmf_mark")
    ransac_gen = torch.Generator(device=dev).manual_seed(
        pm.fold_in(generator.initial_seed(), RANSAC_STREAM))
    region_planes = tsar.fit_region_planes(ransac_gen, weak, disp,
                                           reliable.cpu().numpy(), cams,
                                           params)
    mark("ransac")
    labels = torch.as_tensor(weak.labels_full, dtype=torch.int64,
                             device=dev)
    weak_region = torch.as_tensor(weak.text == -1, device=dev)
    # No border check: bench.py refines without it.
    state2, reliable2, disp2 = tsar.fill_stage(
        cams, state, torch.as_tensor(region_planes, device=dev), labels,
        weak_region, reliable, params)
    mark("fill")
    textured = torch.as_tensor(weak.text == 1, device=dev)[labels]
    if diag is not None:
        diag["reliable_after_mark"] = reliable.cpu().numpy()
        diag["reliable_after_fill"] = reliable2.cpu().numpy()
        diag["depth_after_fill"] = \
            tsar.finalize_stage(cams, state2)[0].cpu().numpy()
        normal, dpl, dp, rl = state2.normal, state2.d, disp2, reliable2
        for it in range(params.wmf_final_iters):
            normal, dpl, dp, rl = wmf.wmf_fill(imgs[0], normal, dpl, dp, rl,
                                               textured, it, cams, params)
            diag[f"depth_wmf_final_{it}"] = tsar.finalize_stage(
                cams, state2._replace(normal=normal, d=dpl))[0].cpu().numpy()
            diag[f"reliable_wmf_final_{it}"] = rl.cpu().numpy()
        state2 = state2._replace(normal=normal, d=dpl)
        reliable2 = rl
    else:
        state2, _, reliable2 = tsar.wmf_final_stage(
            imgs[0], cams, state2, disp2, reliable2, textured, params,
            iters=params.wmf_final_iters)
    mark("wmf_final")
    depth, n_world = tsar.finalize_stage(cams, state2)
    mark("finalize")
    return state, depth, n_world, reliable2


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def matchable_pixels(scene_gt, view_ids) -> tuple[np.ndarray, np.ndarray]:
    """(ok, matchable) of view 0: textured pixels with finite ground
    truth, and those of them that at least one source view sees."""
    gt = scene_gt.depth[0]
    ok = np.isfinite(gt) & ~scene_gt.weak_mask[0]
    cover = source_coverage(scene_gt, ref=0, src_views=view_ids)
    return ok, ok & (cover >= 1)


def rel_error(scene_gt, depth) -> np.ndarray:
    """|depth - true depth| / true depth over view 0 (the divisor 1 where
    the true depth is not finite)."""
    gt = scene_gt.depth[0]
    return np.abs(depth - gt) / np.where(np.isfinite(gt), gt, 1.0)


def depth_pm_of(scene_gt, state) -> np.ndarray:
    """The depth of a PatchMatch state of view 0, on the host."""
    return _host(pm.depth_map(state, cameras(scene_gt, state.d.device)))


def accuracy(scene_gt, state, depth_final, reliable, view_ids) -> dict:
    """bench.py's accuracy keys: the share of pixels within 2% of the true
    depth, for the PatchMatch depth (`acc2_pm`) and the final depth
    (`acc2_final`) over the matchable textured pixels, the final depth
    over those still reliable (`acc2_reliable`), the PatchMatch depth over
    every textured pixel (`acc2_pm_all_textured`), both over the weak
    pixels (`acc2_weak_pm`, `acc2_weak_final`), and the matchable share of
    the textured pixels (`matchable_frac`). Unrounded."""
    gt = scene_gt.depth[0]
    ok, matchable = matchable_pixels(scene_gt, view_ids)
    depth_pm = depth_pm_of(scene_gt, state)
    depth_final = _host(depth_final)
    weak_sel = np.isfinite(gt) & scene_gt.weak_mask[0]

    def acc2(depth, sel):
        return (float((rel_error(scene_gt, depth)[sel] < 0.02).mean())
                if sel.any() else 0.0)

    return {"acc2_pm": acc2(depth_pm, matchable),
            "acc2_final": acc2(depth_final, matchable),
            "acc2_reliable": acc2(depth_final,
                                  _host(reliable).astype(bool) & matchable),
            "acc2_pm_all_textured": acc2(depth_pm, ok),
            "acc2_weak_pm": acc2(depth_pm, weak_sel),
            "acc2_weak_final": acc2(depth_final, weak_sel),
            "matchable_frac": float(matchable[ok].mean())}


def attribution(scene_gt, out, diag: dict, view_ids) -> dict:
    """TSAR_BENCH_DIAG: acc<2% on the matchable textured pixels after each
    refinement stage, and where the loss concentrates (bench.py's keys)."""
    state, depth_final, _, _ = out
    _, matchable = matchable_pixels(scene_gt, view_ids)
    depth_pm = depth_pm_of(scene_gt, state)

    def acc2(depth, sel=matchable):
        if not sel.any():
            return 0
        return round(float((rel_error(scene_gt, depth)[sel] < 0.02).mean()),
                     4)

    rep = {"acc2_pm": acc2(depth_pm),
           "acc2_after_fill": acc2(diag["depth_after_fill"])}
    relm = diag["reliable_after_mark"]
    rep["frac_matchable_marked_unreliable"] = round(
        float((~relm)[matchable].mean()), 4)
    pm_good = rel_error(scene_gt, depth_pm) < 0.02
    rep["frac_good_marked_unreliable"] = round(
        float((~relm)[matchable & pm_good].mean()), 4)
    last_rel = relm
    for k in sorted(k for k in diag if k.startswith("depth_wmf_final_")):
        it = k.rsplit("_", 1)[1]
        rep[f"acc2_wmf_final_{it}"] = acc2(diag[k])
        filled = diag[f"reliable_wmf_final_{it}"] & ~last_rel
        bad_fill = filled & matchable & (
            rel_error(scene_gt, diag[k]) >= 0.02)
        rep[f"filled_{it}"] = int(filled[matchable].sum())
        rep[f"filled_bad_{it}"] = int(bad_fill.sum())
        last_rel = diag[f"reliable_wmf_final_{it}"]
    rep["acc2_final"] = acc2(_host(depth_final))
    return rep


def _agrees(a: dict, exact: bool = False) -> bool:
    """Phases 4 and 8(a)'s bounds of chip_smoke.py on kernel_times.agreement:
    cost and ratio within 1e-3 (B1), or equal (`exact`, B3), the best view
    equal off ties."""
    tol = 0.0 if exact else 1e-3
    return (a["max_abs_err"] <= tol and a["ratio_max_abs_err"] <= tol
            and a["best_view_mismatches"] == 0)


def cuda_crosscheck(scene, params: AlgorithmParams, dev) -> str:
    """Kernels B2 and B1, and B3 when `params`' sampler is the direct one,
    against their plain versions at the bench's full-resolution shape:
    view 0 of `scene` (a utils.synthetic scene), all other views its
    sources, the propagation pass's 4 candidates on parity 0, on a smooth
    plane field (the ground truth perturbed) and a random one. B2 builds
    every source's volume (kernel_times.b2_agreement), B1 evaluates both
    fields on those volumes and B3 on the packed sources (_agrees; B3
    to the bit). Kernel B4 computes the first WMF pass's median plane of
    kernel_times.wmf_truth_call, equal to the bit on every output
    (kernel_times.b4_agreement).
    Returns "ok: max|delta| B1 x B2 y [B3 z] B4 w" or "FAILED: ..." with
    the same numbers; "skipped (cpu)" off the card."""
    from tsar_mvs_tpu_torch import kernel_times as kt
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    from tsar_mvs_tpu_torch.ops import cuda_direct, cuda_ncc, cuda_warp, ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "skipped (cpu)"
    cams = cameras(scene, dev)
    imgs = torch.as_tensor(scene.images, dtype=torch.float32, device=dev)
    H, W = imgs.shape[1:]
    view_ids = tuple(range(1, imgs.shape[0]))
    idx = torch.as_tensor(view_ids, dtype=torch.int64, device=dev)
    counts = pm.svolume_plane_counts(cams, view_ids, H, W, params)
    s_lo, s_hi = sv.s_range_for_depths(params.depth_min, params.depth_max,
                                       params.svolume_margin)
    vol = sv.build_svolume(imgs[idx], cams.A[idx], cams.b[idx], s_lo, s_hi,
                           counts)
    ok, worst = True, {"B1": 0.0, "B2": 0.0}
    for k, v in enumerate(view_ids):
        S = int(counts[k])
        plain = cuda_warp.build_svolume_view_plain(
            imgs[v], cams.A[v], cams.b[v], s_lo, (s_hi - s_lo) / (S - 1), S)
        b2 = kt.b2_agreement(vol.data[k], plain)
        del plain
        ok &= b2["pass"]
        worst["B2"] = max(worst["B2"], b2["max"])
    lv = {"level": 1, "cams": cams, "params": params, "imgs": imgs,
          "counts": counts, "ids": idx, "s_lo": s_lo, "s_hi": s_hi,
          "vol": vol, "stats": ncc.precompute_ref_stats(imgs[0], cams,
                                                        params)}
    gt = {"depth": scene.depth[0], "normal_world": scene.normal_world[0]}
    gen = torch.Generator(device=dev).manual_seed(7)
    st = ncc.compress_stats(lv["stats"], 0)
    direct = pm.resolve_ncc_impl(params) == "direct"
    if direct:
        worst["B3"] = 0.0
        views = kt.direct_inputs(lv, False)[0]
    for n, d in (kt.smooth_field(lv, gt, 4, gen), kt.random_field(lv, 4, gen)):
        n, d = cb.parity_compress_vec(n, 0), cb.parity_compress(d, 0)
        s0, sx, sy = ncc.plane_scalars(n, d, st)
        args = (vol.data, vol.s_lo, vol.inv_ds, idx, s0, sx, sy, st, params,
                0)
        a = kt.agreement(cuda_ncc.multiview_cost(*args),
                         cuda_ncc.multiview_cost_plain(*args))
        ok &= _agrees(a)
        worst["B1"] = max(worst["B1"], a["max_abs_err"])
        if direct:
            args = (views, s0, sx, sy, st, params, 0)
            a = kt.agreement(cuda_direct.multiview_cost_direct(*args),
                             cuda_direct.multiview_cost_direct_plain(*args))
            ok &= _agrees(a, exact=True)
            worst["B3"] = max(worst["B3"], a["max_abs_err"])
    del vol, lv
    # B4 on the view's widest marking pass, inputs from the ground truth.
    args = kt.b4_args(kt.wmf_truth_call(
        scene, cams, params, torch.Generator(device=dev).manual_seed(9)))
    b4 = kt.b4_agreement(wmf.median_plane(*args),
                         wmf._median_plane_plain(*args))
    ok &= b4["max_abs_err"] == 0
    worst["B4"] = b4["max_abs_err"]
    torch.cuda.empty_cache()
    return (("ok: " if ok else "FAILED: ") + "max|delta| "
            + " ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def _profile(scene_gt, params, dev, profile_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        one_view(scene_gt, params, torch.Generator(device=dev).manual_seed(99))
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    print(f"# profile trace written to {profile_dir}", file=sys.stderr)


def run(scene_gt, *, iters: int, repeats: int, ncc_impl: str, small: bool,
        device, profile_dir: str | None = None, diag: bool = False,
        after_views=None) -> dict:
    """The bench on `scene_gt` (view 0 the reference) on `device`: a
    warm-up view (generator seeded 0), with `profile_dir` one profiled view,
    then the fastest of `repeats` views (generator seeded r + 1), the
    accuracy of the last one and the crosscheck. Returns bench.py's JSON
    keys (`cuda_crosscheck` for `tpu_crosscheck`); with `diag`, after the
    warm-up, the stage attribution of one view instead. `after_views()`,
    when given, is called once the views have run, before the crosscheck
    (which launches the kernels to compare them with their plain
    versions)."""
    dev = torch.device(device)
    V, H, W = scene_gt.images.shape
    view_ids = tuple(range(1, V))
    params = bench_params(scene_gt, iters, ncc_impl, small)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# bench: {H}x{W}, {V} views, {iters} iters, impl={ncc_impl} "
          f"on {where}", file=sys.stderr)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    t0 = time.perf_counter()
    out = one_view(scene_gt, params, generator(0))
    print(f"# warmup (incl. compile): {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    if profile_dir:
        _profile(scene_gt, params, dev, profile_dir)
    if diag:
        d: dict = {}
        out = one_view(scene_gt, params, generator(repeats), diag=d)
        return attribution(scene_gt, out, d, view_ids)

    times, stages_best = [], {}
    for r in range(repeats):
        stages: dict[str, float] = {}
        t0 = time.perf_counter()
        out = one_view(scene_gt, params, generator(r + 1), stages)
        times.append(time.perf_counter() - t0)
        if times[-1] == min(times):
            stages_best = stages
    if after_views is not None:
        after_views()
    per_view = min(times)
    state, depth_final, _, reliable = out
    acc = accuracy(scene_gt, state, depth_final, reliable, view_ids)
    _, matchable = matchable_pixels(scene_gt, view_ids)
    print(f"# per-view: {per_view:.3f}s  acc<2% pm={acc['acc2_pm']:.3f} "
          f"final={acc['acc2_final']:.3f} "
          f"reliable-only={acc['acc2_reliable']:.3f} "
          f"all-textured={acc['acc2_pm_all_textured']:.3f} "
          f"(matchable frac {acc['matchable_frac']:.3f}, "
          f"reliable frac {_host(reliable)[matchable].mean():.3f})",
          file=sys.stderr)
    check = cuda_crosscheck(scene_gt, params, dev)
    if dev.type != "cpu":
        print(f"# cuda_crosscheck: {check}", file=sys.stderr)
    # ~20 s/view at 1344x2048 with 7 source views on a GTX 980 (see the
    # module docstring); cost scales about linearly in pixels and views.
    baseline_dm_per_s = 0.05 * (1344 * 2048 / (H * W)) * (7 / max(V - 1, 1))
    return {
        "metric": "depthmaps/sec/chip",
        "value": round(1.0 / per_view, 4),
        "unit": f"depthmaps/s @{H}x{W}x{iters}it/{V - 1}src (full pipeline)",
        "vs_baseline": round(1.0 / per_view / baseline_dm_per_s, 3),
        "stages": {k: round(v, 3) for k, v in stages_best.items()},
        **{k: round(v, 3) for k, v in acc.items()},
        "cuda_crosscheck": check,
    }


def main(argv: list[str] | None = None) -> int:
    from tsar_mvs_tpu_torch import cli
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.bench")
    cli._add_device(p)
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = cli._device(ns)
    if device is None:
        return 1
    small = os.environ.get("TSAR_BENCH_SMALL") == "1"
    # The reference scripts' full operating point: 2K ETH3D views with 7
    # source views (scripts/courtyard.sh).
    H = int(os.environ.get("TSAR_BENCH_H", 160 if small else 1344))
    W = int(os.environ.get("TSAR_BENCH_W", 224 if small else 2048))
    V = int(os.environ.get("TSAR_BENCH_VIEWS", 4 if small else 8))
    iters = int(os.environ.get("TSAR_BENCH_ITERS", 2 if small else 8))
    repeats = int(os.environ.get("TSAR_BENCH_REPEATS", 2))
    diag = os.environ.get("TSAR_BENCH_DIAG") == "1"
    scene_gt = make_scene(height=H, width=W, num_views=V, seed=0,
                          workers=min(V, os.cpu_count() or 1))
    res = run(scene_gt, iters=iters, repeats=repeats,
              ncc_impl=os.environ.get("TSAR_NCC_IMPL", "auto"), small=small,
              device=device, profile_dir=os.environ.get("TSAR_BENCH_PROFILE"),
              diag=diag)
    print(json.dumps(res))
    if diag:
        return 0
    return 1 if res["cuda_crosscheck"].startswith("FAILED") else 0


if __name__ == "__main__":
    raise SystemExit(main())
