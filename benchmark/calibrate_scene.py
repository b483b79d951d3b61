#!/usr/bin/env python3
"""Readings for the limits of a scene cell's check, in one process.

    python3 benchmark/calibrate_scene.py --workload eth3d2k.scene4 \
        --seeds <n> ... [--fault-seeds <n> ...] [--maps-faults ...] \
        [--fusion-faults ...] [--control-seeds <n> ...] [--world <w>] \
        [--backend nccl|gloo]

On the card, at the cell's own size: one scene set up once on `world`
ranks (the cell's chips by default; gloo ranks may share one card, and a
view's maps do not depend on how many ranks share the views: the sharded
path keys every random stream by the global view id). For each seed, a
whole job (``scene_job``: `process_scene` on every rank, `fuse_scene` on
rank 0) with the window's first job seed, and its check; on the first
len(--fault-seeds) sound jobs' maps, each fusion fault of
``scene_faults`` fused again and checked; then each maps fault planted
in every rank on each of --fault-seeds, its maps checked (its fusion
skipped: those faults are the maps numbers' to catch). Last, the control
on its seeds, after the ranks have ended: the truth's maps rounded to
bfloat16 (``reference/control.py``) and the truth's cloud rounded to
bfloat16 (``reference/cloud.py``'s `control_readings`). Prints one JSON
line a reading: {"kind", "seed", "numbers", "per_view", "depth_acc2_pct",
"job"}.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import scene_faults
    p = argparse.ArgumentParser(prog="benchmark/calibrate_scene.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--maps-faults", nargs="*", default=[],
                   choices=scene_faults.MAPS)
    p.add_argument("--fusion-faults", nargs="*", default=[],
                   choices=scene_faults.FUSION)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate_scene: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import run, scene_job, traffic
    from benchmark.reference import check, cloud, control
    _, cell, config = run.load_cell(args.workload)
    limits = check.load_limits(args.workload)
    t0 = time.perf_counter()

    def emit(kind, seed, res, job=None):
        print(json.dumps({"kind": kind, "seed": seed,
                          "numbers": res["numbers"],
                          "per_view": res["per_view"],
                          "depth_acc2_pct": res["depth_acc2_pct"],
                          "correct": res["correct"], "job": job,
                          "at_s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    from tsar_mvs_tpu_torch import _build
    _build.load_library()
    s = scene_job.Session(config, "cuda", args.world or cell["chips"],
                          args.backend)
    try:
        s.job(traffic.view_seed(1, -1))
        for i, seed in enumerate(args.seeds):
            job = s.job(traffic.view_seed(seed, 0))
            emit("sound", seed, s.check(limits), job)
            if i < len(args.fault_seeds):
                for name in args.fusion_faults:
                    s.plant(name)
                    job = s.fuse_again()
                    emit(f"fault:{name}", seed, s.check(limits), job)
                    s.unplant()
        for name in args.maps_faults:
            s.plant(name)
            for seed in args.fault_seeds:
                job = s.job(traffic.view_seed(seed, 0), fuse=False)
                emit(f"fault:{name}", seed, s.check(limits), job)
            s.unplant()
    finally:
        s.close()
    for r, c in zip(control.readings(args.workload, args.control_seeds,
                                     torch.device("cuda")),
                    cloud.control_readings(config, args.control_seeds,
                                           torch.device("cuda"))):
        print(json.dumps({"kind": "control", "seed": r["seed"],
                          "numbers": dict(r["numbers"], **c["numbers"]),
                          "per_view": r["per_view"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
