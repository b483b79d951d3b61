"""The control of the output check: the reference put in the program's
place, in the precision below the one the configuration states.

The configurations state float32 depth, normals and plane state, so the
control holds the reference's maps in bfloat16: every view's true
camera-frame depth and world normals, each rounded to the nearest
bfloat16 and written as float32. Rounding is the least error that any
bfloat16 computation of these maps can have. The check has to find it
not correct; its readings are upper readings of the limits in
``benchmark/limits/`` (``PERF.md`` gives them).
"""

from __future__ import annotations

import numpy as np
import torch

def bf16_maps(scene, ref: int) -> tuple[np.ndarray, np.ndarray]:
    """(depth, world normals) of view `ref`'s truth rounded to bfloat16,
    as float32 arrays (0 where no surface is hit)."""
    depth = scene.depth[ref]
    depth = torch.where(torch.isfinite(depth), depth, 0.0)

    def bf16(x):
        return x.to(torch.bfloat16).float().cpu().numpy()
    return bf16(depth), bf16(scene.normal_world[ref])


def readings(workload: str, seeds, device, resolution=None) -> list[dict]:
    """The check's numbers for the control in place of the program, on
    the cell's scene (at `resolution` when given, else the cell's own),
    with the cell's limits, once a seed: [{"seed", "numbers", "per_view",
    "correct"}]. The control's maps follow from the geometry, which every
    seed shares (a seed moves only the program's draws and a prior)."""
    from benchmark import scene as bench_scene
    from benchmark.reference import check
    from benchmark.run import load_cell
    _, cell, config = load_cell(workload)
    W, H = resolution or config["resolution"]
    geo = config["scene"]
    limits = check.load_limits(workload)
    V = config["images"]
    out = []
    for seed in seeds:
        sd = bench_scene.make_scene(
            H, W, V, geo["texture_seed"], device,
            weak_fraction=geo["weak_fraction"],
            arc_radius=geo["arc_radius"], arc_span_deg=geo["arc_span_deg"],
            pair_top_k=config["pair_top_k"])
        sources = {v: [j for j, _ in sd.pair[v][:config["sources_per_view"]]]
                   for v in range(V)}
        maps = {v: bf16_maps(sd, v) for v in range(V)}
        measured = check.measure(sd, sources, maps, device)
        ok, _ = check.judge(measured["numbers"], limits)
        out.append({"seed": seed, "numbers": measured["numbers"],
                    "per_view": measured["per_view"], "correct": ok})
        del sd
    return out


def main(argv=None) -> int:
    """python3 benchmark/reference/control.py --workload W --seeds S ...
    prints one JSON line a seed: the control's numbers, at the cell's
    size on the card."""
    import argparse
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for r in readings(args.workload, args.seeds, torch.device("cuda")):
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
