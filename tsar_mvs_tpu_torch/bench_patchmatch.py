"""PatchMatch sampler A/B of the port (counterpart of the root
``bench_patchmatch.py``): the direct sampler (kernel B3) against the
s-volume (kernels B1 and B2) at one operating point.

    python -m tsar_mvs_tpu_torch.bench_patchmatch [--device cuda|cpu]

Times ONLY the PatchMatch stage (the coarse-to-fine pyramid exactly as the
bench's patchmatch stage runs it) for each sampler on the same synthetic
scene, and prints one JSON line per sampler:

    {"impl": ..., "per_view_s": N, "warmup_s": N, "acc2_pm": N, "point": ...}

or {"impl": ..., "error": ...} for a sampler that failed, after which the
run exits 1.

Environment: TSAR_BENCH_H/W/VIEWS/ITERS (672/1024/4/8), TSAR_AB_IMPLS
(comma list, default "direct,svolume,pallas"; pallas runs as svolume),
TSAR_AB_REPEATS (2), and the parameter overrides of AB_KNOBS:
TSAR_AB_STEP (svolume_step_px), TSAR_AB_DZ0 (refine_dz0_frac),
TSAR_AB_DZ0F (refine_dz0_frac_fine), TSAR_AB_STEPPX_BUDGET
(svolume_budget_mb), TSAR_AB_BANKSF (prop_banks_fine), TSAR_AB_SCHED=8,4
(iterations per pyramid level, coarse to fine), TSAR_AB_COLOR=1
(color_processing on three scaled copies of the gray views). TSAR_AB_RBF
has no effect: the port does not carry refine_block_frac.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from tsar_mvs_tpu_torch import bench, convert, pipeline
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models import patchmatch as pm

# (environment variable, AlgorithmParams field, type).
AB_KNOBS = (("TSAR_AB_STEP", "svolume_step_px", float),
            ("TSAR_AB_DZ0", "refine_dz0_frac", float),
            ("TSAR_AB_DZ0F", "refine_dz0_frac_fine", float),
            ("TSAR_AB_STEPPX_BUDGET", "svolume_budget_mb", int),
            ("TSAR_AB_BANKSF", "prop_banks_fine", int))


def knobs_from_env(environ) -> tuple[dict, tuple[int, ...] | None, bool]:
    """(AlgorithmParams overrides, iterations per level or None, colour)
    from the TSAR_AB_* variables of `environ`. TSAR_AB_RBF warns."""
    extra = {field: kind(environ[var]) for var, field, kind in AB_KNOBS
             if environ.get(var)}
    if environ.get("TSAR_AB_RBF"):
        print("warning: TSAR_AB_RBF has no effect: the port does not carry "
              "refine_block_frac (tile-blocked refine draws of the TPU "
              "kernel)", file=sys.stderr)
    sched = (tuple(int(t) for t in environ["TSAR_AB_SCHED"].split(","))
             if environ.get("TSAR_AB_SCHED") else None)
    color = environ.get("TSAR_AB_COLOR") == "1"
    if color:
        extra["color_processing"] = True
    return extra, sched, color


def run(scene_gt, impls, *, iters: int, repeats: int, device,
        extra: dict | None = None, sched: tuple[int, ...] | None = None,
        color: bool = False) -> list[dict]:
    """The PatchMatch pyramid of view 0 of `scene_gt` (every other view a
    source) per sampler in `impls`: a warm-up run (generator seeded 0),
    then the fastest of `repeats` (seeded r + 1), and acc2_pm of the last
    over the matchable textured pixels. `extra` overrides AlgorithmParams
    fields, `sched` gives the iterations per level and `color` runs on
    three channels (the gray views, 0.8 and 0.6 times them). Prints and
    returns one record per sampler; a sampler that raises gives
    {"impl", "error"} (traceback on stderr) and the others still run."""
    dev = torch.device(device)
    V, H, W = scene_gt.images.shape
    cams = bench.cameras(scene_gt, dev)
    imgs = torch.as_tensor(scene_gt.images, dtype=torch.float32, device=dev)
    view_ids = tuple(range(1, V))
    levels = pipeline.pyramid_levels_for(H)
    if sched is not None and len(sched) != len(levels):
        raise ValueError(f"TSAR_AB_SCHED {sched} needs one count per level "
                         f"of {levels}")
    _, ok = bench.matchable_pixels(scene_gt, view_ids)
    imgs_color = None
    if color:
        rgb = np.repeat(np.asarray(scene_gt.images)[:, None], 3,
                        axis=1).astype(np.float32)
        rgb[:, 1] *= 0.8
        rgb[:, 2] *= 0.6
        imgs_color = torch.as_tensor(rgb, device=dev)
    out = []
    for impl in impls:
        params = convert.algorithm_params(AlgorithmParams(
            iterations=iters, ncc_impl=impl, **(extra or {}))
        ).with_depth_range(scene_gt.depth_min, scene_gt.depth_max,
                           float(cams.f))

        def once(seed):
            st = pm.run_patchmatch_pyramid(
                torch.Generator(device=dev).manual_seed(seed), imgs,
                view_ids, list(scene_gt.P), params, levels=levels,
                iterations_per_level=sched, depth_min=scene_gt.depth_min,
                depth_max=scene_gt.depth_max, imgs_color=imgs_color)
            bench.sync(dev)
            return st

        t0 = time.perf_counter()
        try:
            state = once(0)
        except Exception as e:  # noqa: BLE001 — reported per sampler
            traceback.print_exc()
            rec = {"impl": impl, "error": repr(e)[:300]}
        else:
            warmup = time.perf_counter() - t0
            times = []
            for r in range(repeats):
                t0 = time.perf_counter()
                state = once(r + 1)
                times.append(time.perf_counter() - t0)
            rel = bench.rel_error(scene_gt, bench.depth_pm_of(scene_gt,
                                                              state))
            rec = {"impl": impl, "per_view_s": round(min(times), 3),
                   "warmup_s": round(warmup, 1),
                   "acc2_pm": round(float((rel[ok] < 0.02).mean()), 4),
                   "point": f"{H}x{W}x{iters}it/{V - 1}src"}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv: list[str] | None = None) -> int:
    from tsar_mvs_tpu_torch import cli
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.bench_patchmatch")
    cli._add_device(p)
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = cli._device(ns)
    if device is None:
        return 1
    H = int(os.environ.get("TSAR_BENCH_H", 672))
    W = int(os.environ.get("TSAR_BENCH_W", 1024))
    V = int(os.environ.get("TSAR_BENCH_VIEWS", 4))
    iters = int(os.environ.get("TSAR_BENCH_ITERS", 8))
    repeats = int(os.environ.get("TSAR_AB_REPEATS", 2))
    impls = os.environ.get("TSAR_AB_IMPLS",
                           "direct,svolume,pallas").split(",")
    extra, sched, color = knobs_from_env(os.environ)
    print(f"# ab: {H}x{W}, {V} views, {iters} iters on {device}",
          file=sys.stderr)
    scene_gt = make_scene(height=H, width=W, num_views=V, seed=0,
                          workers=min(V, os.cpu_count() or 1))
    res = run(scene_gt, impls, iters=iters, repeats=repeats, device=device,
              extra=extra, sched=sched, color=color)
    return 1 if any("error" in r for r in res) else 0


if __name__ == "__main__":
    raise SystemExit(main())
