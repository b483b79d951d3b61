#!/usr/bin/env python3
"""Readings for the limits of the output check, many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault <name> --fault-seeds <n> ...] \
        [--textures <n> ...]

On the card, at the cell's own size: for each seed, `run.run_cell` with
its set-up, one rotation of the mix's views (as many as a run compares)
and its output check; then the control (`reference/control.py`) and the
faults planted in the program, each on its seeds; then, on other
textures than the configuration's, one seed each. Prints one JSON line a
reading: {"kind", "seed", "numbers", "per_view", "depth_acc2_pct",
"view_s"}. ``PERF.md`` says which readings set each limit.

Faults (`FAULTS`: the module of the program, the function of it that
each replaces, and the replacement), planted in the program for the
readings only:

- ``fill_offset``: the fill writes its region planes' depth 5% long;
- ``fill_skipped``: the fill returns the state unchanged;
- ``depth_long``: `finalize_stage` returns the depth 5% long;
- ``normals_camera``: `finalize_stage` returns the normals in the
  reference camera's frame, not the world's;
- ``refine_unchanged``: `tsar_refine` writes the plane field it was
  given (a lifted prior, or PatchMatch's) unrefined;
- ``color_sources_rotated`` (a colour cell): the sources' channels are
  rotated (R <- G <- B) in the colour images that
  ``models/patchmatch``'s `run_patchmatch_pyramid` is given; the
  reference view's stay.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fill_offset(real):
    def planted(cams, state, region_planes, *a, **k):
        scaled = region_planes.clone()
        scaled[:, 3] *= 1.05
        return real(cams, state, scaled, *a, **k)
    return planted


def fill_skipped(real):
    from tsar_mvs_tpu_torch.models import tsar

    def planted(cams, state, region_planes, labels, weak_region, reliable,
                params):
        return state, reliable, tsar.disparity_of(cams, state.normal,
                                                  state.d)
    return planted


def depth_long(real):
    def planted(cams, state):
        depth, normal = real(cams, state)
        return depth * 1.05, normal
    return planted


def normals_camera(real):
    def planted(cams, state):
        depth, _ = real(cams, state)
        return depth, state.normal
    return planted


def refine_unchanged(real):
    import dataclasses

    def planted(*a, **k):
        res = real(*a, **k)
        return dataclasses.replace(res, depth=res.depth_pm)
    return planted


def color_sources_rotated(real):
    def planted(*a, imgs_color=None, **k):
        if imgs_color is not None:
            imgs_color = imgs_color.clone()
            imgs_color[1:] = imgs_color[1:, [1, 2, 0]]
        return real(*a, imgs_color=imgs_color, **k)
    return planted


FAULTS = {"fill_offset": ("tsar", "fill_stage", fill_offset),
          "fill_skipped": ("tsar", "fill_stage", fill_skipped),
          "depth_long": ("tsar", "finalize_stage", depth_long),
          "normals_camera": ("tsar", "finalize_stage", normals_camera),
          "refine_unchanged": ("tsar", "tsar_refine", refine_unchanged),
          "color_sources_rotated": ("patchmatch", "run_patchmatch_pyramid",
                                    color_sources_rotated)}


def reading(kind: str, seed: int, res: dict) -> str:
    m = res["measured"]
    return json.dumps({"kind": kind, "seed": seed, "numbers": m["numbers"],
                       "per_view": m["per_view"],
                       "depth_acc2_pct": m["depth_acc2_pct"],
                       "attempted": res["attempted"],
                       "failed": res["failed"]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", action="append", default=[],
                   choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--textures", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import run
    from benchmark.reference import control
    _, _, config = run.load_cell(args.workload)
    views = config["images"]

    def one(seed, cfg=None):
        return run.run_cell(args.workload, seed, 0.0, False,
                            config=cfg, t_start=time.perf_counter(),
                            min_views=views)

    for seed in args.seeds:
        print(reading("sound", seed, one(seed)), flush=True)
    for r in control.readings(args.workload, args.control_seeds,
                              torch.device("cuda")):
        print(json.dumps({"kind": "control", "seed": r["seed"],
                          "numbers": r["numbers"],
                          "per_view": r["per_view"]}), flush=True)
    for name in args.fault:
        module, target, plant = FAULTS[name]
        module = importlib.import_module(
            f"tsar_mvs_tpu_torch.models.{module}")
        real = getattr(module, target)
        setattr(module, target, plant(real))
        try:
            for seed in args.fault_seeds:
                print(reading(f"fault:{name}", seed, one(seed)), flush=True)
        finally:
            setattr(module, target, real)
    for t in args.textures:
        cfg = dict(config, scene=dict(config["scene"], texture_seed=t))
        seed = args.seeds[0] if args.seeds else 1
        print(reading(f"texture:{t}", seed, one(seed, cfg)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
