"""The fused cloud (``results/TSAR_fused.ply``) against the scene's exact
surfaces, in plain PyTorch float64. It imports nothing of the program.

The scene's surfaces are its rectangles (``benchmark/scene.py``), each an
origin and two edge vectors in the world frame; the cloud is read back
from disk with this module's own PLY reader. The tolerance `tau` is 2%
of the scene's median true depth over every view (the same 2% as
`depth_acc2`, fixed once for the scene as ETH3D fixes an absolute
tolerance). The numbers:

- `cloud_acc_bad`: the share of the fused points farther than `tau` from
  every truth surface;
- `cloud_comp_bad`: the share of the seen truth pixels (finite truth, at
  least one of the view's sources sees it) on a fixed grid of every
  view (every `GRID`-th row and column) that no fused point covers: a
  pixel is covered when some point projects onto it (rounded to the
  nearest pixel) and lies within `tau` of its true surface point. Pooled
  over the views;
- `cloud_bf16_grid`: the share of the PLY's float32 coordinates whose
  low 16 bits are zero, i.e. that lie on the bfloat16 grid: the
  configuration states float32 points, which land there 2^-16 of the
  time, and a cloud fused or held in bfloat16 always does (at world
  coordinates of 4-5 bfloat16's spacing is 0.016-0.03, under `tau`, so
  the two shares above cannot see it);
- `cloud_missing`: 1 when there is no PLY or it holds no point, else 0.

Without a cloud the shares cannot be read and are NaN (the check prints
them as null and fails them).

The control of the cloud (`control_cloud`, beside ``control.py``'s maps
in bfloat16): the reference's cloud in bfloat16, the true world point of
every seen pixel on the coverage grid of every view, each rounded to the
nearest bfloat16.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import truth as tr

F64 = torch.float64
GRID = 4
CHUNK = 1 << 22
_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
              "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}


def read_ply_points(path: Path) -> np.ndarray | None:
    """(N, 3) float32 x, y, z of a binary little-endian PLY's vertices, or
    None when the file does not exist."""
    try:
        data = Path(path).read_bytes()
    except FileNotFoundError:
        return None
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n, fields = 0, []
    for line in data[:end].decode("ascii").splitlines():
        words = line.split()
        if words[:1] == ["format"] and words[1] != "binary_little_endian":
            raise ValueError(f"{path}: {words[1]}, not binary_little_endian")
        if words[:2] == ["element", "vertex"]:
            n = int(words[2])
        elif words[:1] == ["property"]:
            fields.append((words[2], _PLY_TYPES[words[1]]))
    rows = np.frombuffer(data, np.dtype(fields), count=n, offset=end)
    return np.stack([rows["x"], rows["y"], rows["z"]], -1)


def tolerance(depth: torch.Tensor) -> float:
    """2% of the median of every view's finite true depth."""
    return 0.02 * float(torch.median(depth[torch.isfinite(depth)]))


def _segment_distance(p, a, b):
    ab = b - a
    s = torch.clamp(((p - a) @ ab) / float(ab @ ab), 0.0, 1.0)
    return torch.linalg.vector_norm(p - (a + s[:, None] * ab), dim=-1)


def surface_distance(points: torch.Tensor, rects) -> torch.Tensor:
    """(N,) distance of each point to the nearest rectangle: to its plane
    where the point projects inside it, else to its nearest edge."""
    best = torch.full(points.shape[:1], torch.inf, dtype=F64,
                      device=points.device)
    for origin, eu, ev in rects:
        o, u, v = (torch.as_tensor(np.asarray(x, np.float64),
                                   device=points.device)
                   for x in (origin, eu, ev))
        n = torch.linalg.cross(u, v)
        n = n / torch.linalg.vector_norm(n)
        rel = points - o
        # In-plane coordinates of the projection (u and v need not be
        # orthogonal).
        G = torch.stack([torch.stack([u @ u, u @ v]),
                         torch.stack([u @ v, v @ v])])
        uv = torch.linalg.solve(G, torch.stack([rel @ u, rel @ v]))
        inside = (uv >= 0).all(0) & (uv <= 1).all(0)
        edges = torch.stack([_segment_distance(points, a, b) for a, b in (
            (o, o + u), (o + u, o + u + v), (o + v, o + u + v), (o, o + v))])
        d = torch.where(inside, (rel @ n).abs(), edges.min(0).values)
        best = torch.minimum(best, d)
    return best


def grid_truth(scene, v: int, sources, dev) -> tuple:
    """View v's grid (every `GRID`-th row and column from `GRID` // 2):
    (seen, the (h, w) mask of its seen pixels; X_true, their (h, w, 3)
    true world points, 0 where not seen)."""
    H, W = scene.depth.shape[1:]
    off = GRID // 2
    ys = torch.arange(off, H, GRID, device=dev)
    xs = torch.arange(off, W, GRID, device=dev)
    seen = tr.ViewTruth(scene, v, sources).seen[ys][:, xs]
    z = scene.depth[v][ys][:, xs]
    K = torch.as_tensor(scene.K, dtype=F64, device=dev)
    R = torch.as_tensor(scene.R[v], dtype=F64, device=dev)
    t = torch.as_tensor(scene.t[v], dtype=F64, device=dev)
    gy, gx = torch.meshgrid(ys.to(F64), xs.to(F64), indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    X_true = ((pix @ torch.linalg.inv(K).T)
              * torch.where(seen, z, 0.0)[..., None] - t) @ R
    return seen, X_true


def view_coverage(scene, v: int, sources, points: torch.Tensor,
                  tau: float) -> tuple[int, int]:
    """(seen grid pixels of view v, of those the ones no point covers)."""
    dev = points.device
    H, W = scene.depth.shape[1:]
    off = GRID // 2
    seen, X_true = grid_truth(scene, v, sources, dev)
    K = torch.as_tensor(scene.K, dtype=F64, device=dev)
    R = torch.as_tensor(scene.R[v], dtype=F64, device=dev)
    t = torch.as_tensor(scene.t[v], dtype=F64, device=dev)
    covered = torch.zeros(seen.shape, dtype=torch.bool, device=dev)
    for c in range(0, points.shape[0], CHUNK):
        p = points[c:c + CHUNK]
        q = (p @ R.T + t) @ K.T
        front = q[:, 2] > 0
        px = torch.round(q[:, 0] / q[:, 2])
        py = torch.round(q[:, 1] / q[:, 2])
        on = (front & torch.isfinite(px) & torch.isfinite(py)
              & (px >= off) & (py >= off) & (px < W) & (py < H))
        on &= (torch.remainder(px - off, GRID) == 0) \
            & (torch.remainder(py - off, GRID) == 0)
        gi = ((py[on] - off) / GRID).long()
        gj = ((px[on] - off) / GRID).long()
        near = torch.linalg.vector_norm(p[on] - X_true[gi, gj], dim=-1) < tau
        covered[gi[near], gj[near]] = True
    return int(seen.sum()), int((seen & ~covered).sum())


def bf16_grid_share(pts: np.ndarray) -> float:
    """The share of the float32 coordinates whose low 16 bits are 0."""
    bits = np.ascontiguousarray(pts, np.float32).view(np.uint32)
    return float(np.count_nonzero((bits & 0xFFFF) == 0)) / bits.size


def measure(scene, rects, sources: dict, ply: Path, device) -> dict:
    """The numbers of the cloud in PLY file `ply` (see `measure_points`)."""
    return measure_points(scene, rects, sources, read_ply_points(ply),
                          device)


def measure_points(scene, rects, sources: dict, pts: np.ndarray | None,
                   device) -> dict:
    """The cloud's numbers. `scene` holds the truth (K, R, t, depth; the
    depth on `device`), `rects` the truth surfaces as (origin, eu, ev),
    `sources[v]` view v's source views, `pts` the (N, 3) float32 points
    (None: no cloud)."""
    if pts is None or pts.shape[0] == 0:
        return {"cloud_missing": 1, "cloud_acc_bad": math.nan,
                "cloud_comp_bad": math.nan, "cloud_bf16_grid": math.nan,
                "cloud_points": 0}
    points = torch.as_tensor(pts, device=device).to(F64)
    tau = tolerance(scene.depth)
    bad = sum(int((surface_distance(points[c:c + CHUNK], rects) > tau).sum())
              for c in range(0, points.shape[0], CHUNK))
    seen = gaps = 0
    for v in range(scene.depth.shape[0]):
        s, g = view_coverage(scene, v, sources[v], points, tau)
        seen += s
        gaps += g
    return {"cloud_missing": 0, "cloud_acc_bad": bad / points.shape[0],
            "cloud_comp_bad": gaps / seen if seen else math.nan,
            "cloud_bf16_grid": bf16_grid_share(pts),
            "cloud_points": int(points.shape[0]), "cloud_tau": tau}


def control_cloud(scene, sources: dict, device) -> np.ndarray:
    """The reference's cloud rounded to bfloat16, as (N, 3) float32: the
    true world point of every seen pixel on `grid_truth`'s grid of every
    view. `scene` holds the truth, its depth on `device`."""
    pts = []
    for v in range(scene.depth.shape[0]):
        seen, X = grid_truth(scene, v, sources[v], device)
        pts.append(X[seen].to(torch.bfloat16).float().cpu().numpy())
    return np.concatenate(pts)


def control_readings(config: dict, seeds, device) -> list[dict]:
    """The cloud's numbers for the control in place of the program's
    cloud, on the configuration's scene at its own size, once a seed:
    [{"seed", "numbers"}]. The control follows from the geometry, which
    every seed shares."""
    from benchmark import scene as bench_scene
    W, H = config["resolution"]
    geo = config["scene"]
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
        rects = [(r.origin, r.eu, r.ev)
                 for r in bench_scene.rectangles(geo["weak_fraction"])]
        out.append({"seed": seed, "numbers": measure_points(
            sd, rects, sources, control_cloud(sd, sources, device), device)})
        del sd
    return out
