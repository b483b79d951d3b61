"""Scaling harness of the port (counterpart of the root
``bench_scaling.py``): depth maps per second against the number of ranks
of the view-sharded PatchMatch (``parallel/mesh.patchmatch_sharded``).

    python -m tsar_mvs_tpu_torch.bench_scaling

One spawned rank per card under NCCL, at 1, 2, 4, ... ranks up to the
number of cards; with TSAR_SCALE_CPU=1 gloo ranks on the CPU, one thread
each, up to 8 (the counterpart of the JAX harness's 8-device CPU mesh; the
ranks share the host's cores). Several scenes are
concatenated along the reference axis (multi-scene batching). Weak
scaling gives every rank the same number of references (ideal: flat
wall-clock, efficiency t(1) / t(n)); strong scaling fixes the total at
refs/rank x the largest count. Each count runs once untimed, then three
times between barriers; rank 0 reports the fastest. Prints one JSON line
per count ({"devices", "refs", "wall_s", "depthmaps_per_s"[, "fuse_s"]})
and a summary line.

Environment: TSAR_SCALE_H/W (96/128), TSAR_SCALE_ITERS (2),
TSAR_SCALE_REFS_PER_DEV (1), TSAR_SCALE_SCENES (2), TSAR_SCALE_MODE
(weak|strong), TSAR_SCALE_FUSE=1 (also times parallel/mesh.fuse_sharded),
TSAR_SCALE_CPU=1. Without a card and without TSAR_SCALE_CPU the run exits
1.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Source views of every reference, as in the JAX harness.
N_SRC = 3
COUNTS = (1, 2, 4, 8, 16, 32)
CPU_RANKS = 8


def rank_counts(cpu: bool) -> list[int]:
    """The rank counts of a run: up to CPU_RANKS gloo ranks, or one rank
    per card."""
    limit = CPU_RANKS if cpu else torch.cuda.device_count()
    return [c for c in COUNTS if c <= limit]


def scaling_point(refs: int, height: int, width: int, iters: int,
                  num_scenes: int, dev):
    """The batch of one point: `refs` references spread round-robin over
    `num_scenes` synthetic scenes (seeds 0..), each with its first N_SRC
    other views as sources, the image ids offset into one stack of every
    scene's views. Returns (batch, images, the last scene's cameras,
    params, the last scene) as the JAX harness builds them."""
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    batches, imgs, base = [], [], 0
    for s in range(num_scenes):
        scene = make_scene(height=height, width=width,
                           num_views=max(N_SRC + 1, 4), seed=s)
        r_s = refs // num_scenes + (1 if s < refs % num_scenes else 0)
        if r_s == 0:
            continue
        V = scene.num_views
        ref_ids = [i % V for i in range(r_s)]
        src_ids = [[j for j in range(V) if j != r][:N_SRC] for r in ref_ids]
        b = pm.build_scene_batch(list(scene.P), ref_ids, src_ids, N_SRC,
                                 device=dev)
        batches.append(b._replace(ref_ids=b.ref_ids + base,
                                  src_ids=b.src_ids + base))
        imgs.append(np.asarray(scene.images, np.float32))
        base += V
    batch = pm.SceneBatch(*(torch.cat(xs) for xs in zip(*batches)))
    cams = geo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                                depth_max=scene.depth_max, device=dev)
    params = AlgorithmParams(iterations=iters).with_depth_range(
        scene.depth_min, scene.depth_max, float(cams.f))
    return (batch, torch.as_tensor(np.concatenate(imgs), device=dev), cams,
            params, scene)


def _fastest(mesh, fn, repeats: int = 3) -> float:
    """fn() once untimed, then the fastest of `repeats` runs, each between
    barriers, on rank 0's clock."""
    import torch.distributed as dist
    fn()
    times = []
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        dist.barrier()
        times.append(time.perf_counter() - t0)
    return min(times)


def _rank_body(refs: int, height: int, width: int, iters: int,
               num_scenes: int, cpu: bool, fuse: bool, out: str) -> None:
    """One rank of a point: its slice of the references through
    patchmatch_sharded (and with `fuse` fuse_sharded on ground-truth maps);
    rank 0 writes the record to <out>/rank0.json."""
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.config import FusionParams
    from tsar_mvs_tpu_torch.parallel import mesh as pmesh
    if cpu:
        torch.set_num_threads(1)
    mesh = pmesh.view_mesh("cpu" if cpu else "cuda")
    batch, imgs, cams, params, scene = scaling_point(
        refs, height, width, iters, num_scenes, mesh.device)
    cost_sums = []

    def patchmatch():
        states = pmesh.patchmatch_sharded(mesh, 0, imgs, batch, cams, params,
                                          iterations=iters)
        local = torch.stack([st.cost.double().sum() for st in states]) \
            if states else torch.zeros(0, dtype=torch.float64,
                                       device=mesh.device)
        # Every reference's summed cost, in reference order, on the host.
        cost_sums[:] = pmesh.gather_views(mesh, local, refs)[:refs].tolist()

    n = mesh.world
    rec = {"devices": n, "refs": refs,
           "wall_s": _fastest(mesh, patchmatch)}
    rec["depthmaps_per_s"] = refs / rec["wall_s"]
    rec["cost_sum"] = math.fsum(cost_sums)
    if fuse:
        Vf = -(-refs // n) * n
        V = scene.num_views
        cams_w = geo.build_camera_set([scene.P[i % V] for i in range(Vf)],
                                      rebase=False, device=mesh.device)
        mine = range(Vf)[mesh.local_slice(Vf)]
        depths = torch.as_tensor(np.stack(
            [np.where(np.isfinite(scene.depth[i % 4]), scene.depth[i % 4],
                      0.0) for i in mine]), dtype=torch.float32,
            device=mesh.device)
        normals = torch.as_tensor(np.stack(
            [scene.normal_world[i % 4] for i in mine]), device=mesh.device)
        rec["fuse_s"] = _fastest(mesh, lambda: pmesh.fuse_sharded(
            mesh, depths, normals, cams_w, FusionParams()))
    if mesh.rank == 0:
        (Path(out) / "rank0.json").write_text(json.dumps(rec))


def run_count(n: int, refs: int | None = None, *, height: int = 96,
              width: int = 128, iters: int = 2, scenes: int = 2,
              cpu: bool = False, fuse: bool = False) -> dict:
    """One point: `refs` references (default n, one a rank) over `n`
    spawned ranks, NCCL with one card each or, with `cpu`, gloo on the
    CPU. Returns {"devices", "refs", "wall_s", "depthmaps_per_s",
    "cost_sum" (every reference's summed PatchMatch cost, in reference
    order: the same at every n for the same refs) [, "fuse_s"]},
    unrounded."""
    from tsar_mvs_tpu_torch.parallel import distributed
    refs = n if refs is None else refs
    if not cpu:
        from tsar_mvs_tpu_torch import _build
        _build.load_library()  # once here, not in every rank
    with tempfile.TemporaryDirectory() as tmp:
        distributed.run_ranks(_rank_body, n, f"file://{tmp}/pg",
                              "gloo" if cpu else "nccl",
                              (refs, height, width, iters, scenes, cpu, fuse,
                               tmp))
        return json.loads((Path(tmp) / "rank0.json").read_text())


def record(res: dict) -> dict:
    """The JSON line of one point, as the JAX harness prints it."""
    rec = {"devices": res["devices"], "refs": res["refs"],
           "wall_s": round(res["wall_s"], 4),
           "depthmaps_per_s": round(res["depthmaps_per_s"], 3)}
    if "fuse_s" in res:
        rec["fuse_s"] = round(res["fuse_s"], 4)
    return rec


def summary(results: list[dict], mode: str, cpu: bool, height: int,
            width: int) -> list[dict]:
    """The summary lines: weak (or CPU strong) scaling efficiency t(1) /
    t(n); on cards in strong mode the speed-up t(1) / t(n) and the
    efficiency t(1) / (n t(n))."""
    t1, tn = results[0]["wall_s"], results[-1]["wall_s"]
    n_last = results[-1]["devices"]
    n_ratio = n_last / results[0]["devices"]
    if mode == "strong" and not cpu:
        speedup = t1 / tn
        eff = speedup / n_ratio
        return [{"metric": "strong_scaling_speedup",
                 "value": round(speedup, 3),
                 "unit": f"t(1dev)/t({n_last}dev) @{height}x{width}"},
                {"metric": "strong_scaling_efficiency",
                 "value": round(eff, 3),
                 "unit": f"t(1)/(n*t(n)), n={n_last} @{height}x{width}",
                 "vs_baseline": round(eff / 0.85, 3)}]
    eff = t1 / tn
    out = {"metric": f"{mode}_scaling_efficiency", "value": round(eff, 3),
           "unit": f"t(1dev)/t({n_last}dev) @{height}x{width}",
           "vs_baseline": round(eff / 0.85, 3)}
    if mode == "strong":
        out["note"] = ("CPU ranks of one thread each, sharing the host's "
                       "cores: fixed total work, value t(1)/t(n) not "
                       "normalised by n")
    return [out]


def main(argv: list[str] | None = None) -> int:
    cpu = os.environ.get("TSAR_SCALE_CPU") == "1"
    if not cpu and not torch.cuda.is_available():
        print("no CUDA device: set TSAR_SCALE_CPU=1 to run gloo ranks on "
              "the CPU", file=sys.stderr)
        return 1
    H = int(os.environ.get("TSAR_SCALE_H", 96))
    W = int(os.environ.get("TSAR_SCALE_W", 128))
    iters = int(os.environ.get("TSAR_SCALE_ITERS", 2))
    refs_per_dev = int(os.environ.get("TSAR_SCALE_REFS_PER_DEV", 1))
    scenes = int(os.environ.get("TSAR_SCALE_SCENES", 2))
    mode = os.environ.get("TSAR_SCALE_MODE", "weak")
    if mode not in ("weak", "strong"):
        print(f"TSAR_SCALE_MODE must be weak or strong, got {mode!r}",
              file=sys.stderr)
        return 2
    fuse = os.environ.get("TSAR_SCALE_FUSE") == "1"
    counts = rank_counts(cpu)
    print(f"# scaling[{mode}]: {H}x{W}x{iters}it, {refs_per_dev} refs/dev, "
          f"{scenes} scenes, devices={max(counts)} "
          f"({'cpu' if cpu else torch.cuda.get_device_name(0)})",
          file=sys.stderr)
    results = []
    for n in counts:
        refs = refs_per_dev * (max(counts) if mode == "strong" else n)
        res = run_count(n, refs, height=H, width=W, iters=iters,
                        scenes=scenes, cpu=cpu, fuse=fuse)
        print(json.dumps(record(res)), flush=True)
        results.append(res)
    for line in summary(results, mode, cpu, H, W):
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
