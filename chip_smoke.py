#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tsar_mvs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero without the final
line:
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   no CUDA device is a failure;
2. build the CUDA kernels from csrc/ (timed);
3. kernel B2 (s-volume build) against its plain PyTorch version for the
   1344x2048 synthetic scene's cameras, one source view at its full plane
   count: |delta| median 0, q99.9 <= 1.0, max <= 2.0 intensity levels;
4. kernel B1 (s-volume NCC cost) against its plain version at 672x1024:
   a random plane field, 8 candidates with invalid (d = 0) ones, both
   parities; on pixels where either cost is below 0.99, median < 5e-4 and
   q99 < 5e-3, fewer than 1% of all pixels off by more than 0.1, and
   invalid candidates exactly cost_max;
5. the main path: process_view of a 1344x2048, 8-view synthetic scene
   (7 sources, 8 iterations, default AlgorithmParams) with per-stage
   seconds, peak device memory, kernel launch counts and accuracy against
   the scene's ground truth (acc2_pm and acc2_final must reach 0.95);
6. the scene on the same scene: process_scene(resume=True) runs the 7
   other views (view 0's artifacts from phase 5 are kept), fuse_scene
   with the default FusionParams, and the fused cloud's F1@2cm against
   the GT cloud of scripts/validate_synthetic.py (F1 must reach 0.94,
   every view's acc2_final 0.95; the JAX package's record there is 0.9625,
   RESULTS.md planar:0);
7. the APD prior: view 1 gets APD/<name>/depths_geom.dmb (GT depth with
   0.5% noise, 5% of pixels redrawn within +-30%), normals.dmb (GT
   world normals) and weak.png (0 on the redrawn pixels), then
   process_view three times: as the reference runs the prior (no
   PatchMatch; acc2_final must reach 0.95), and with 2 full-resolution
   PatchMatch iterations from the lifted prior, under the default
   4096 MiB s-volume budget (acc2_final must reach 0.85) and under
   16384 MiB (acc2_final must reach 0.95); both kernels must launch in
   each PatchMatch run.

Then one JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H, W, VIEWS = 1344, 2048, 8


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, repeats: int) -> float:
    """Mean device milliseconds per call over `repeats` after a warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def check_warp(scene, params, dev) -> dict:
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import pipeline
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


def check_ncc(scene, params, dev) -> dict:
    import torch
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.ops import checkerboard as cb
    from tsar_mvs_tpu_torch.ops import cuda_ncc, ncc
    from tsar_mvs_tpu_torch.ops import svolume as sv
    order, view_ids = pipeline.view_image_order(scene, 0, params.max_views)
    cams = geo.build_camera_set([scene.P[i] for i in order], cam_scale=2.0,
                                depth_min=scene.depth_min,
                                depth_max=scene.depth_max, device=dev)
    params2 = params.with_depth_range(scene.depth_min, scene.depth_max,
                                      float(cams.f))
    imgs = pm.downsample_2x(torch.as_tensor(scene.images[order],
                                            device=dev))
    Hs, Ws = imgs.shape[1:]
    counts = pipeline.scene_plane_counts(scene, params, (4, 2, 1),
                                         len(view_ids))[1]
    slot = max(range(len(counts)), key=lambda k: counts[k])
    s_lo, s_hi = sv.s_range_for_depths(params2.depth_min, params2.depth_max,
                                       params2.svolume_margin)
    vol = sv.build_svolume(imgs[slot + 1:slot + 2], cams.A[slot + 1:slot + 2],
                           cams.b[slot + 1:slot + 2], s_lo, s_hi,
                           [counts[slot]])
    stats = ncc.precompute_ref_stats(imgs[0], cams, params2)
    g = torch.Generator(device=dev).manual_seed(7)
    C = 8
    n = geo.normalize(torch.randn((C, Hs, Ws, 3), generator=g, device=dev))
    n = geo.hemisphere_flip(n, geo.view_vectors(cams, Hs, Ws))
    depth = (scene.depth_min * 1.05 + (scene.depth_max * 0.95
             - scene.depth_min * 1.05)
             * torch.rand((C, Hs, Ws), generator=g, device=dev))
    d = geo.plane_d_from_depth(n, stats.rays, depth)
    invalid = torch.zeros((C, Hs, Ws), dtype=torch.bool, device=dev)
    invalid[7] = True
    invalid[5] = torch.rand((Hs, Ws), generator=g, device=dev) < 0.1
    d = torch.where(invalid, 0.0, d)
    res = {"shape": [C, Hs, Ws // 2], "planes": counts[slot]}
    worst = 0.0
    for parity in (0, 1):
        st = ncc.compress_stats(stats, parity)
        n_p = cb.parity_compress_vec(n, parity)
        d_p = cb.parity_compress(d, parity)
        inv_p = cb.parity_compress(invalid, parity)
        s0, sx, sy = sv.plane_scalars(n_p, d_p, st)

        def kernel():
            return cuda_ncc.svolume_cost(vol.data[0], vol.s_lo, vol.inv_ds[0],
                                         s0, sx, sy, st, params2, parity)

        def plain():
            return cuda_ncc.svolume_cost_plain(vol.data[0], vol.s_lo,
                                               vol.inv_ds[0], s0, sx, sy, st,
                                               params2, parity)

        ck, cp = kernel(), plain()
        delta = (ck - cp).abs()
        sharp = (torch.minimum(ck, cp) < 0.99) & ~inv_p
        ds_ = delta[sharp]
        r = {"sharp_frac": float(sharp.float().mean()),
             "median": float(torch.quantile(ds_, 0.5)),
             "q99": float(torch.quantile(ds_, 0.99)),
             "max_sharp": float(ds_.max()), "max": float(delta.max()),
             "frac_gt_0.1": float((delta > 0.1).float().mean()),
             "invalid_exact": bool((ck[inv_p] == params2.cost_max).all()
                                   and (cp[inv_p] == params2.cost_max).all())}
        if parity == 0:
            r["ms"] = time_ms(kernel, 10)
            r["plain_ms"] = time_ms(plain, 3)
            res.update(ms=r["ms"], plain_ms=r["plain_ms"])
        ok = (r["median"] < 5e-4 and r["q99"] < 5e-3
              and r["frac_gt_0.1"] < 0.01 and r["invalid_exact"]
              and r["sharp_frac"] > 0.3)
        worst = max(worst, r["max"])
        print(f"B1 ncc vs plain, parity {parity}: {json.dumps(r)} -> "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("B1 disagrees with its plain version")
    res["max_abs_err"] = worst
    return res


def acc2_for(scene_gt, scene, ref: int, depth):
    """acc2 of a depth map over the matchable textured pixels of view
    `ref` (finite GT, not weak, seen by a source of its pair.txt) and over
    its weak pixels: {"textured": x, "weak": y}."""
    import numpy as np
    from tsar_mvs_tpu.utils.synthetic import source_coverage
    from tsar_mvs_tpu_torch import pipeline
    order, _ = pipeline.view_image_order(scene, ref, 14)
    gt = scene_gt.depth[ref]
    ok_px = np.isfinite(gt) & ~scene_gt.weak_mask[ref]
    matchable = ok_px & (source_coverage(scene_gt, ref=ref,
                                         src_views=order[1:]) >= 1)
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


def reset_launches() -> None:
    from tsar_mvs_tpu_torch.ops import cuda_ncc, cuda_warp
    cuda_ncc.LAUNCHES = 0
    cuda_warp.LAUNCHES = 0


def read_launches() -> dict:
    from tsar_mvs_tpu_torch.ops import cuda_ncc, cuda_warp
    return {"ncc": cuda_ncc.LAUNCHES, "warp": cuda_warp.LAUNCHES}


def run_main_path(scene_gt, root: Path, dev) -> dict:
    import numpy as np
    import torch
    from tsar_mvs_tpu.config import AlgorithmParams
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
    peak = torch.cuda.max_memory_allocated()

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
           "launches": launches, **acc, "missing": missing,
           "depth_finite": finite}
    print(f"main path: {json.dumps(res)}", flush=True)
    if missing or not finite:
        raise SystemExit(f"main path artifacts: missing {missing}, "
                         f"finite depth {finite}")
    if min(launches.values()) == 0:
        raise SystemExit(f"a kernel was not launched: {launches}")
    if acc["acc2_pm"] < 0.95 or acc["acc2_final"] < 0.95:
        raise SystemExit(f"accuracy below 0.95: {acc}")
    return res


def load_gt_cloud(scene_gt):
    """The GT cloud of scripts/validate_synthetic.py (every view's GT
    depth backprojected, stride 4), imported by path."""
    import importlib.util
    path = (Path(__file__).resolve().parent / "scripts"
            / "validate_synthetic.py")
    spec = importlib.util.spec_from_file_location("validate_synthetic", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gt_cloud(scene_gt)


def run_scene_phase(scene_gt, root: Path, dev) -> dict:
    """process_scene (resume: view 0 is phase 5's), fuse_scene, F1@2cm."""
    import numpy as np
    import torch
    from tsar_mvs_tpu import eval as ev
    from tsar_mvs_tpu.utils import dmb, ply
    from tsar_mvs_tpu_torch import pipeline
    scene = pipeline.load_scene(root)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pipeline.process_scene(root, resume=True, device=dev)
    torch.cuda.synchronize()
    views_s = time.perf_counter() - t0
    launches = read_launches()
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
    fs = ev.point_cloud_fscore(pts, load_gt_cloud(scene_gt), threshold=0.02)
    res = {"per_view_s": per_view_s, "views_s": views_s,
           "acc2_final": acc2_final, "fuse_s": fuse_s,
           "points": n_points, "f1": fs.f1, "precision": fs.precision,
           "recall": fs.recall, "score_s": time.perf_counter() - t0,
           "launches": launches}
    print(f"scene phase: {json.dumps(res)}", flush=True)
    if min(launches.values()) == 0:
        raise SystemExit(f"a kernel was not launched in the scene: "
                         f"{launches}")
    if fs.f1 < 0.94 or min(acc2_final) < 0.95:
        raise SystemExit(f"scene below its limits: F1 {fs.f1}, "
                         f"acc2_final {acc2_final}")
    return res


# (pm_iterations, svolume_budget_mb, least acc2_final) of phase 7's runs.
# The default budget leaves view 1's full-resolution volume at 18 to 211
# planes per source, a maximum epipolar spacing of about 34 px against
# the 2 px design step, and PatchMatch from the prior then falls to
# about 0.71 (0.89 after refinement; NVIDIA H100 80GB HBM3, 700.00 W).
# 16384 MiB narrows the spacing to about 7 px (peak about 19.5 GB).
APD_RUNS = ((0, 4096, 0.95), (2, 4096, 0.85), (2, 16384, 0.95))


def run_apd_phase(scene_gt, root: Path, dev) -> list[dict]:
    """View 1 refined from a noisy GT prior: once as the reference runs
    it (no PatchMatch), then with 2 full-resolution PatchMatch iterations
    from the lifted prior under two s-volume budgets."""
    import numpy as np
    import torch
    from tsar_mvs_tpu.config import AlgorithmParams
    from tsar_mvs_tpu.utils import display, dmb
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
    for pm_iterations, budget, least in APD_RUNS:
        stages: dict[str, float] = {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = stage_timer(stages)
        reset_launches()
        t0 = time.perf_counter()
        result = pipeline.process_view(
            scene, ref, AlgorithmParams(svolume_budget_mb=budget),
            pm_iterations=pm_iterations,
            out_dir=root.parent / f"apd_pm{pm_iterations}_{budget}",
            device=dev, timer=timer)
        torch.cuda.synchronize()
        res = {"pm_iterations": pm_iterations, "svolume_budget_mb": budget,
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
        if pm_iterations and min(res["launches"].values()) == 0:
            raise SystemExit(f"a kernel was not launched on the APD branch: "
                             f"{res['launches']}")
        if res["acc2_final"] < least:
            raise SystemExit(f"APD, {pm_iterations} PatchMatch iterations, "
                             f"{budget} MiB: acc2_final below {least}: "
                             f"{res['acc2_final']}")
        out.append(res)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tsar_mvs_tpu.config import AlgorithmParams
    from tsar_mvs_tpu.utils.synthetic import make_scene
    from tsar_mvs_tpu_torch import _build, pipeline

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.2f} s ({_build.library_path().name}); "
          f"{' | '.join(ptxas)}", flush=True)

    t = time.perf_counter()
    scene_gt = make_scene(height=H, width=W, num_views=VIEWS, seed=0)
    root = Path(tempfile.mkdtemp(prefix="tsar_smoke_")) / "scene"
    scene_gt.export(root)
    scene = pipeline.load_scene(root)
    params = pipeline.default_params_for_scene(scene, AlgorithmParams())
    print(f"scene: {H}x{W}x{VIEWS} in {time.perf_counter() - t:.1f} s",
          flush=True)

    warp = check_warp(scene, params, dev)
    ncc_res = check_ncc(scene, params, dev)
    torch.cuda.empty_cache()
    main_res = run_main_path(scene_gt, root, dev)
    torch.cuda.empty_cache()
    run_scene_phase(scene_gt, root, dev)
    torch.cuda.empty_cache()
    run_apd_phase(scene_gt, root, dev)

    kernels = [
        {"name": "svol_ncc", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/ncc.cu",
         "replaces": "tsar_mvs_tpu/ops/pallas_ncc.py:117",
         "launches": main_res["launches"]["ncc"],
         "max_abs_err": ncc_res["max_abs_err"], "ms": ncc_res["ms"],
         "plain_ms": ncc_res["plain_ms"]},
        {"name": "warp_build", "route": "cuda",
         "source": "tsar_mvs_tpu_torch/csrc/warp.cu",
         "replaces": "tsar_mvs_tpu/ops/pallas_warp.py:155",
         "launches": main_res["launches"]["warp"],
         "max_abs_err": warp["max"], "ms": warp["ms"],
         "plain_ms": warp["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
