"""The comparison that decides `correct`, and `depth_acc2`.

After the window has closed, the last instance of every reference view of
the rotation is read back from disk (``TSAR_disp.dmb``,
``TSAR_normals.dmb``) and measured against the scene's truth
(`truth.view_measures`), one view at a time on the device. The numbers:

- `tex_bad2_mean` and `tex_bad2_max`: the mean and the largest over the
  views of the share of the textured pixels that a source sees whose
  depth is off by 2% or more;
- `tex_err_med`: the largest over the views of the median relative depth
  error on those pixels;
- `tex_err_p25_min`: the smallest over the views of the 25th percentile
  of that error, the best view's accuracy, which a depth held in
  bfloat16 cannot reach (its rounding alone reads about 6.4e-4);
- `tex_nrm_med_deg`: the largest over the views of the median angle in
  degrees between the written and the true normal on those pixels
  (either orientation);
- `weak_bad2_mean` and `weak_bad2_med`: the mean and the median over the
  views that see textureless pixels of the share of those pixels off by
  2% or more (the region planes of B5, the border check and the fill);
- `bf16_grid_max`: the largest over the views of the share of the seen
  pixels whose written depth lies on the bfloat16 grid: the
  configuration states float32 depth, which lands there 2^-16 of the
  time, and a depth held in bfloat16 always does;
- `views_missing`: views of the rotation with no maps written.

A cell's limits file (``benchmark/limits/<workload>.json``) names the
numbers it compares, each with its limit, set between the readings of
sound runs of the program and of the control (`control.py`) or a fault
planted in the program; `PERF.md` gives those readings. `depth_acc2` is
the share, in %, of all pixels with a finite truth that a source sees
(the textured and the textureless alike) whose written depth lies within
2% of the truth, pooled over the views.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from benchmark.reference import truth as tr

HERE = Path(__file__).resolve().parents[1]
def load_limits(workload: str) -> dict:
    """{number: {"limit": x, ...}} of a cell, the numbers it compares."""
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return {k: v for k, v in limits.items() if isinstance(v, dict)}


def read_maps(out_dir: Path):
    """(depth, normals) a view wrote to `out_dir`, or None."""
    try:
        return (tr.read_dmb(out_dir / "TSAR_disp.dmb"),
                tr.read_dmb(out_dir / "TSAR_normals.dmb"))
    except FileNotFoundError:
        return None


def measure(scene, sources: dict, maps: dict, device) -> dict:
    """The numbers and the pooled accuracy. `scene` holds the truth
    (depth moved to `device` here; the rest moves a view at a time),
    `sources[v]` view v's source views, `maps[v]` its written (depth,
    normals) arrays or None when it wrote nothing."""
    truth_scene = _OnDevice(scene, device)
    per_view = {}
    good = seen = 0.0
    for v in sorted(maps):
        if maps[v] is None:
            continue
        truth = tr.ViewTruth(truth_scene, v, sources[v])
        depth = torch.as_tensor(maps[v][0].copy(), device=device)
        normal = torch.as_tensor(maps[v][1].copy(), device=device)
        m = tr.view_measures(truth, depth, normal)
        per_view[v] = m
        n_seen = float(truth.seen.sum())
        good += m["acc2"] * n_seen
        seen += n_seen

    def over_views(key):
        return [m[key] for m in per_view.values() if m[key] is not None]

    numbers = {"views_missing": len(maps) - len(per_view)}
    if per_view:
        tex_bad2 = over_views("tex_bad2")
        numbers.update(tex_bad2_mean=sum(tex_bad2) / len(tex_bad2),
                       tex_bad2_max=_largest(tex_bad2))
        for k in ("tex_err_med", "tex_nrm_med_deg"):
            numbers[k] = _largest(over_views(k))
        numbers["tex_err_p25_min"] = _smallest(over_views("tex_err_p25"))
        numbers["bf16_grid_max"] = _largest(over_views("bf16_grid"))
        weak = over_views("weak_bad2")
        if weak:
            numbers.update(weak_bad2_mean=sum(weak) / len(weak),
                           weak_bad2_med=_median(weak))
    return {"numbers": numbers, "per_view": per_view,
            "depth_acc2_pct": 100.0 * good / seen if seen else 0.0}


def _largest(xs: list) -> float:
    """The largest of xs, NaN when any is NaN."""
    return math.nan if any(math.isnan(x) for x in xs) else max(xs)


def _smallest(xs: list) -> float:
    """The smallest of xs, NaN when any is NaN."""
    return math.nan if any(math.isnan(x) for x in xs) else min(xs)


def _median(xs: list) -> float:
    ys = sorted(xs)
    mid = len(ys) // 2
    return ys[mid] if len(ys) % 2 else 0.5 * (ys[mid - 1] + ys[mid])


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value": x, "limit": y}}) over the numbers
    that `limits` names: each at or below its limit. A number the run
    could not read (every view missing, a NaN) fails, and is printed as
    null."""
    out, ok = {}, True
    for k, lim in limits.items():
        value = numbers.get(k, math.nan)
        ok &= bool(value <= lim["limit"])
        out[k] = {"value": None if math.isnan(value) else value,
                  "limit": lim["limit"]}
    return ok, out


class _OnDevice:
    """The truth of a scene with its depths on `device` (the source
    coverage reads every view's depth)."""

    def __init__(self, scene, device):
        self.K, self.R, self.t = scene.K, scene.R, scene.t
        self.depth = scene.depth.to(device)
        self.normal_world = scene.normal_world
        self.weak_mask = scene.weak_mask
