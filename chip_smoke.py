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
   the scene's ground truth (acc2_pm and acc2_final must reach 0.95).

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


def run_main_path(scene_gt, root: Path, dev) -> dict:
    import numpy as np
    import torch
    from tsar_mvs_tpu.config import AlgorithmParams
    from tsar_mvs_tpu.utils.synthetic import source_coverage
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.ops import cuda_ncc, cuda_warp
    scene = pipeline.load_scene(root)
    stages: dict[str, float] = {}
    last = [time.perf_counter()]

    def timer(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ncc.LAUNCHES = 0
    cuda_warp.LAUNCHES = 0
    t0 = time.perf_counter()
    last[0] = t0
    result = pipeline.process_view(scene, 0, AlgorithmParams(), device=dev,
                                   timer=timer)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"ncc": cuda_ncc.LAUNCHES, "warp": cuda_warp.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    order, _ = pipeline.view_image_order(scene, 0, 14)
    gt = scene_gt.depth[0]
    ok_px = np.isfinite(gt) & ~scene_gt.weak_mask[0]
    cover = source_coverage(scene_gt, ref=0, src_views=order[1:])
    matchable = ok_px & (cover >= 1)
    weak_sel = np.isfinite(gt) & scene_gt.weak_mask[0]

    def acc2(depth, sel):
        rel = np.abs(depth - gt) / np.where(np.isfinite(gt), gt, 1.0)
        return float((rel[sel] < 0.02).mean()) if sel.any() else 0.0

    acc = {"acc2_pm": acc2(result.depth_pm, matchable),
           "acc2_final": acc2(result.depth, matchable),
           "acc2_weak_pm": acc2(result.depth_pm, weak_sel),
           "acc2_weak_final": acc2(result.depth, weak_sel),
           "matchable_frac": float(matchable[ok_px].mean())}
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
