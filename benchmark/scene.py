"""The benchmark's synthetic scene, rendered on the card in float64.

A copy of ``tsar_mvs_tpu_torch.utils.synthetic.make_scene`` at
``geometry_jitter`` 0, planar weak patch, no noise: a large slanted
textured background plane with a soft-edged textureless patch, and a
tilted textured foreground rectangle, seen from cameras on an arc. The
texture is the same hash value noise, seeded by the configuration's
texture seed. Rewritten in PyTorch so that a 2048x1344 view renders in
a fraction of a second on the card instead of tens of seconds in numpy.

The renderer also gives the exact ground truth the output check compares
with: camera-frame depth (inf where no surface is hit), world normals
and the textureless mask, all kept in float64 on the device.

A colour scene (`make_scene(..., color=True)`) traces the rays once and
evaluates the value noise three times, from the texture seed, seed + 1
and seed + 2 (`texture`: the luma and two chroma differences, so that the
channels differ and correlate as a photo's do); the textureless patch
keeps its flat albedo in every channel. Its gray images are the BT.601
luma 0.299 R + 0.587 G + 0.114 B, as OpenCV's grayscale read of the same
colour file gives them, which is the gray scene's texture to rounding;
the truth is the gray scene's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

F64 = torch.float64


@dataclass
class Rect:
    origin: np.ndarray
    eu: np.ndarray
    ev: np.ndarray
    flat_patch: tuple[float, float, float, float] | None = None
    albedo: float = 0.5

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)


@dataclass
class SceneData:
    images: torch.Tensor        # (V, H, W) float32 in [0, 255], device
    depth: torch.Tensor         # (V, H, W) float64 camera z, inf = miss
    normal_world: torch.Tensor  # (V, H, W, 3) float64
    weak_mask: torch.Tensor     # (V, H, W) bool: textureless core
    K: np.ndarray               # (3, 3)
    R: np.ndarray               # (V, 3, 3)
    t: np.ndarray               # (V, 3)
    P: np.ndarray               # (V, 3, 4)
    depth_min: float
    depth_max: float
    pair: dict[int, list[tuple[int, float]]]   # pair.txt's ranking
    # (V, 3, H, W) float32 RGB in [0, 255], device; None for a gray scene
    images_color: torch.Tensor | None = None


def look_at(C: np.ndarray, target: np.ndarray,
            up=np.array([0.0, -1.0, 0.0])) -> tuple[np.ndarray, np.ndarray]:
    z = target - C
    z = z / np.linalg.norm(z)
    x = np.cross(-up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ C


def _dot(a: torch.Tensor, v) -> torch.Tensor:
    """a (..., 3) . v (3,), summed left to right."""
    return a[..., 0] * float(v[0]) + a[..., 1] * float(v[1]) \
        + a[..., 2] * float(v[2])


def _hash3(p: torch.Tensor, seed: int) -> torch.Tensor:
    """Integer lattice hash -> uniform [0, 1] (int64 arithmetic, no
    overflow for lattice coordinates below 2**22)."""
    x = (p[..., 0] * 374761393 + p[..., 1] * 668265263
         + p[..., 2] * 2147483647 + seed * 144665) & 0xFFFFFFFF
    x = ((x ^ (x >> 13)) * 1274126177) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    return (x & 0xFFFFFF).to(F64) / float(0xFFFFFF)


def value_noise(X: torch.Tensor, seed: int, octaves: int,
                base_freq: float = 2.0,
                persistence: float = 0.5) -> torch.Tensor:
    """Multi-octave value noise over world points X (..., 3), in [0, 1]."""
    out = torch.zeros(X.shape[:-1], dtype=F64, device=X.device)
    amp_total = 0.0
    for o in range(octaves):
        freq = base_freq * (2.0 ** o)
        amp = persistence ** o
        P = X * freq
        P0f = torch.floor(P)
        f = P - P0f
        P0 = torch.nan_to_num(P0f, nan=0.0, posinf=0.0,
                              neginf=0.0).to(torch.int64)
        f = f * f * (3 - 2 * f)
        acc = torch.zeros_like(out)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = P0 + torch.tensor([dx, dy, dz],
                                               device=X.device)
                    h = _hash3(corner, seed + o * 101)
                    w = ((f[..., 0] if dx else 1 - f[..., 0])
                         * (f[..., 1] if dy else 1 - f[..., 1])
                         * (f[..., 2] if dz else 1 - f[..., 2]))
                    acc = acc + w * h
        out = out + amp * acc
        amp_total += amp
    return out / amp_total


# The colour texture's chroma: Cb and Cr span +-CHROMA / 2 of full scale
# around gray, so that R, G and B stay inside [0, 1] where the luma does.
CHROMA = 0.2


def texture(X: torch.Tensor, seed: int, octaves: int,
            channels: int) -> torch.Tensor:
    """Albedo in [0, 1] of world points X (..., 3), (channels, ...). Gray:
    the value noise of `seed`. Colour: that noise is the luma Y, the value
    noises of seed + 1 and seed + 2 the chroma Cb and Cr, and R, G, B
    follow by BT.601's inverse, G from the luma itself, so that 0.299 R +
    0.587 G + 0.114 B is Y to rounding: the colour scene's luma is the
    gray scene's texture, and its channels correlate as a photo's do."""
    def noise(s):
        return value_noise(X, seed=s, octaves=octaves, persistence=0.7)
    luma = 0.15 + 0.7 * noise(seed)
    if channels == 1:
        return luma[None]
    cb = CHROMA * (noise(seed + 1) - 0.5)
    cr = CHROMA * (noise(seed + 2) - 0.5)
    red = luma + 1.402 * cr
    blue = luma + 1.772 * cb
    green = (luma - 0.299 * red - 0.114 * blue) / 0.587
    return torch.stack([red, green, blue])


def render_view(R: np.ndarray, t: np.ndarray, K: np.ndarray,
                rects: list[Rect], height: int, width: int, seed: int,
                device, channels: int = 1) -> tuple[torch.Tensor, ...]:
    """Ray-cast one view: (image (channels, H, W), camera-frame depth with
    inf for a miss, world normals, textureless mask); `texture` gives the
    albedo of each channel."""
    f = K[0, 0]
    yy, xx = torch.meshgrid(torch.arange(height, dtype=F64, device=device),
                            torch.arange(width, dtype=F64, device=device),
                            indexing="ij")
    C = -R.T @ t
    M = R.T @ np.linalg.inv(K)
    dirs = torch.stack([M[i, 0] * xx + M[i, 1] * yy + M[i, 2]
                        for i in range(3)], -1)
    Ct = torch.tensor(C, dtype=F64, device=device)
    best_s = torch.full((height, width), torch.inf, dtype=F64, device=device)
    tex_val = torch.zeros((channels, height, width), dtype=F64,
                          device=device)
    hit_n = torch.zeros((height, width, 3), dtype=F64, device=device)
    hit_weak = torch.zeros((height, width), dtype=torch.bool, device=device)
    # Resolution-matched texture: the finest octave has a 2-4 px
    # wavelength at this render size (see the program's make_scene).
    px_per_unit = f / 5.0
    octs = int(np.clip(np.ceil(np.log2(
        max(px_per_unit / 3.0, 4.0) / 2.0)) + 1, 4, 9))
    for rect in rects:
        n = rect.normal
        denom = _dot(dirs, n)
        s = float((rect.origin - C) @ n) / torch.where(
            denom.abs() < 1e-12, torch.nan, denom)
        X = Ct + s[..., None] * dirs
        rel = X - torch.tensor(rect.origin, dtype=F64, device=device)
        u = _dot(rel, rect.eu) / float(rect.eu @ rect.eu)
        w_ = _dot(rel, rect.ev) / float(rect.ev @ rect.ev)
        valid = (torch.isfinite(s) & (s > 0) & (u >= 0) & (u <= 1)
                 & (w_ >= 0) & (w_ <= 1) & (s < best_s))
        val = texture(X, seed, octs, channels)
        in_patch = torch.zeros_like(valid)
        if rect.flat_patch is not None:
            u0, u1, v0, v1 = rect.flat_patch
            margin = 0.25
            du = (torch.minimum(u - u0, u1 - u) / (u1 - u0)) / margin
            dv = (torch.minimum(w_ - v0, v1 - w_) / (v1 - v0)) / margin
            inside = torch.minimum(du, dv)
            tex_w = torch.clamp(1.0 - inside, 0.0, 1.0)
            tex_w = tex_w * tex_w * (3 - 2 * tex_w)
            val = val * tex_w + rect.albedo * (1.0 - tex_w)
            in_patch = inside > 0.55
        best_s = torch.where(valid, s, best_s)
        tex_val = torch.where(valid, val, tex_val)
        hit_n = torch.where(valid[..., None],
                            torch.tensor(n, dtype=F64, device=device), hit_n)
        hit_weak = torch.where(valid, in_patch, hit_weak)
    X = Ct + best_s[..., None] * dirs
    z = _dot(X, R[2]) + float(t[2])
    img = torch.clamp(tex_val * 255.0, 0, 255)
    return (img, torch.where(torch.isfinite(best_s), z, torch.inf), hit_n,
            hit_weak)


def cameras(height: int, width: int, num_views: int, arc_radius: float,
            arc_span_deg: float):
    """(K, Rs, ts, Ps): cameras on an arc looking at (0, 0, 5)."""
    f = 1.2 * width
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]])
    target = np.array([0.0, 0.0, 5.0])
    angles = np.linspace(-np.deg2rad(arc_span_deg / 2),
                         np.deg2rad(arc_span_deg / 2), num_views)
    Rs, ts, Ps = [], [], []
    for a in angles:
        C = np.array([arc_radius * np.sin(a), 0.35 * np.sin(2 * a),
                      5.0 - arc_radius * np.cos(a)])
        R, t = look_at(C, target)
        Rs.append(R)
        ts.append(t)
        Ps.append(K @ np.concatenate([R, t[:, None]], axis=1))
    return K, np.stack(Rs), np.stack(ts), np.stack(Ps)


def rectangles(weak_fraction: float) -> list[Rect]:
    wf = max(0.05, min(weak_fraction, 0.9))
    patch = (0.55, 0.55 + 0.35 * wf * 4, 0.30, 0.30 + 0.30 * wf * 4)
    return [Rect(origin=np.array([-8.0, -6.0, 6.5]),
                 eu=np.array([16.0, 0.0, 1.2]),
                 ev=np.array([0.0, 12.0, -0.8]), albedo=0.62,
                 flat_patch=patch),
            Rect(origin=np.array([-1.6, -1.4, 4.2]),
                 eu=np.array([1.8, 0.0, 0.7]),
                 ev=np.array([0.0, 1.6, -0.3]))]


def pair_ranking(R: np.ndarray, t: np.ndarray,
                 top_k: int) -> dict[int, list[tuple[int, float]]]:
    """pair.txt's ranking: the other views by camera-centre distance."""
    V = R.shape[0]
    centers = np.stack([-R[i].T @ t[i] for i in range(V)])
    pair = {}
    for i in range(V):
        dist = np.linalg.norm(centers - centers[i], axis=1)
        order = [int(j) for j in np.argsort(dist) if j != i]
        pair[i] = [(j, float(1.0 / (1e-6 + dist[j]))) for j in order[:top_k]]
    return pair


def make_scene(height: int, width: int, num_views: int, seed: int,
               device, weak_fraction: float = 0.25, arc_radius: float = 4.0,
               arc_span_deg: float = 40.0, pair_top_k: int = 10,
               color: bool = False) -> SceneData:
    K, Rs, ts, Ps = cameras(height, width, num_views, arc_radius,
                            arc_span_deg)
    rects = rectangles(weak_fraction)
    views = [render_view(Rs[v], ts[v], K, rects, height, width, seed, device,
                         channels=3 if color else 1)
             for v in range(num_views)]
    rgb = torch.stack([v[0] for v in views])
    if color:
        images_color = rgb.to(torch.float32)
        images = (0.299 * rgb[:, 0] + 0.587 * rgb[:, 1]
                  + 0.114 * rgb[:, 2]).to(torch.float32)
    else:
        images_color = None
        images = rgb[:, 0].to(torch.float32)
    del rgb
    depth = torch.stack([v[1] for v in views])
    # The depth range from the float32 depths, as the program's
    # make_scene takes it.
    d32 = depth.to(torch.float32)
    finite = d32[torch.isfinite(d32)]
    dmin, dmax = float(finite.min()), float(finite.max())
    margin = 0.15 * (dmax - dmin)
    return SceneData(
        images=images, depth=depth,
        normal_world=torch.stack([v[2] for v in views]),
        weak_mask=torch.stack([v[3] for v in views]), K=K, R=Rs, t=ts, P=Ps,
        depth_min=max(1e-3, dmin - margin), depth_max=dmax + margin,
        pair=pair_ranking(Rs, ts, pair_top_k), images_color=images_color)
