"""Synthetic multi-view scenes with exact ground truth.

The reference repo ships no image data (its de-facto test suite is 13
ETH3D scenes run by shell scripts, SURVEY.md §4); we instead generate
view-consistent synthetic scenes — textured 3-D rectangles rendered by
ray casting with a procedural world-space texture — so unit/regression
tests and benchmarks have exact depth/normal ground truth.

Cameras are generated on an arc and exported in the same Middlebury/MVSNet
`cams/xxxxxxxx_cam.txt` + `pair.txt` contract the reference consumes
(fileIoUtils.h:111-163, main.cpp:1345-1384).

The port's own copy of ``tsar_mvs_tpu.utils.synthetic``
(same semantics, no jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tsar_mvs_tpu_torch.utils.scene_io import (CamFile, PairFile,
                                               write_cam_file,
                                               write_pair_file)


@dataclass
class Rect3D:
    """A textured 3-D rectangle: origin + two edge vectors.

    flat_patch, when set, marks a (u0, u1, v0, v1) sub-rectangle in the
    rect's local (u, v) coordinates that renders with constant albedo —
    a textureless region embedded in a textured surface (the bare-wall
    case TSAR's weak-region pipeline targets)."""
    origin: np.ndarray   # (3,)
    eu: np.ndarray       # (3,) edge 1
    ev: np.ndarray       # (3,) edge 2
    textured: bool = True
    albedo: float = 0.5
    flat_patch: tuple[float, float, float, float] | None = None

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)


@dataclass
class Cyl3D:
    """A textureless vertical cylinder section: the curved weak-region
    case where a single RANSAC plane is wrong BY CONSTRUCTION (the fitted
    chord plane misses the surface by up to the sagitta) and the fine WMF
    must carry the fill. A soft texture ramp near the angular/height rim
    gives the region the matchable coplanar-ish halo real bare columns
    have."""
    c0: np.ndarray        # (3,) bottom center of the axis
    axis: np.ndarray      # (3,) unit axis direction
    radius: float
    height: float
    face_dir: np.ndarray  # (3,) unit: outward direction of the visible arc
    span_deg: float = 120.0   # angular extent of the section
    albedo: float = 0.55
    rim: float = 0.18         # fractional rim width with texture ramp


def value_noise(X: np.ndarray, seed: int = 0, octaves: int = 4,
                base_freq: float = 2.0,
                persistence: float = 0.5) -> np.ndarray:
    """Deterministic multi-octave value noise over 3-D points X (..., 3),
    in [0, 1]. Hash-based — view-consistent by construction."""
    out = np.zeros(X.shape[:-1])
    amp_total = 0.0
    for o in range(octaves):
        freq = base_freq * (2.0 ** o)
        amp = persistence ** o
        P = X * freq
        P0 = np.floor(P).astype(np.int64)
        f = P - P0
        f = f * f * (3 - 2 * f)  # smoothstep
        acc = np.zeros(X.shape[:-1])
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = P0 + np.array([dx, dy, dz])
                    h = _hash3(corner, seed + o * 101)
                    w = (np.where(dx, f[..., 0], 1 - f[..., 0])
                         * np.where(dy, f[..., 1], 1 - f[..., 1])
                         * np.where(dz, f[..., 2], 1 - f[..., 2]))
                    acc += w * h
        out += amp * acc
        amp_total += amp
    return out / amp_total


def _hash3(p: np.ndarray, seed: int) -> np.ndarray:
    """Integer lattice hash -> uniform [0, 1]."""
    x = (p[..., 0] * 374761393 + p[..., 1] * 668265263
         + p[..., 2] * 2147483647 + seed * 144665) & 0xFFFFFFFF
    x = (x ^ (x >> 13)) * 1274126177 & 0xFFFFFFFF
    x = x ^ (x >> 16)
    return (x & 0xFFFFFF) / float(0xFFFFFF)


@dataclass
class SyntheticScene:
    images: np.ndarray       # (V, H, W) float32 in [0, 255]
    P: np.ndarray            # (V, 3, 4) projection matrices (world frame)
    K: np.ndarray            # (3, 3)
    R: np.ndarray            # (V, 3, 3)
    t: np.ndarray            # (V, 3)
    depth: np.ndarray        # (V, H, W) GT depth (camera z), inf = miss
    normal_cam: np.ndarray   # (V, H, W, 3) GT normals in each view's frame
    normal_world: np.ndarray  # (V, H, W, 3)
    weak_mask: np.ndarray    # (V, H, W) bool: pixel lies on textureless rect
    depth_min: float = 0.0
    depth_max: float = 0.0

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    def export(self, root: str | Path, pair_top_k: int = 10) -> Path:
        """Write the scene in the reference's on-disk contract:
        images/0000000v.png (plus .pfm fallback), cams/0000000v_cam.txt,
        pair.txt (ranked by camera-center proximity)."""
        root = Path(root)
        (root / "images").mkdir(parents=True, exist_ok=True)
        (root / "cams").mkdir(parents=True, exist_ok=True)
        from tsar_mvs_tpu_torch.utils.pfm import write_pfm
        centers = np.stack([-self.R[i].T @ self.t[i]
                            for i in range(self.num_views)])
        pair = PairFile()
        for i in range(self.num_views):
            name = f"{i:08d}"
            write_pfm(root / "images" / f"{name}.pfm", self.images[i])
            _write_png_gray(root / "images" / f"{name}.png", self.images[i])
            write_cam_file(root / "cams" / f"{name}_cam.txt", CamFile(
                R=self.R[i], t=self.t[i], K=self.K,
                depth_min=self.depth_min,
                depth_interval=(self.depth_max - self.depth_min) / 192,
                depth_num=192, depth_max=self.depth_max))
            dist = np.linalg.norm(centers - centers[i], axis=1)
            order = [int(j) for j in np.argsort(dist) if j != i]
            pair.neighbors[i] = [(j, float(1.0 / (1e-6 + dist[j])))
                                 for j in order[:pair_top_k]]
        write_pair_file(root / "pair.txt", pair)
        return root


def source_coverage(scene: "SyntheticScene", ref: int = 0,
                    src_views=None, border: int = 1,
                    occl_tol: float = 0.01) -> np.ndarray:
    """Per-pixel count of source views in which the ref pixel's GT
    surface point is actually observable (reprojection in bounds and not
    occluded, by the source view's own GT depth).

    Pixels with count 0 cannot be matched by ANY multi-view stereo
    method — at the bench scene's 40-degree arc that is ~17% of textured
    ref pixels, which caps naive all-textured acc<2% at ~0.83 (the
    "0.723 plateau" of rounds 1-2 was this ceiling, not the engine:
    restricted to count>=1 pixels the engine measures 0.94)."""
    H, W = scene.depth.shape[1:]
    src_views = range(1, scene.num_views) if src_views is None else src_views
    gt = scene.depth[ref]
    K, R, t = scene.K, scene.R, scene.t
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xx, yy, np.ones_like(xx)], -1).astype(np.float64)
    X_cam = np.einsum("ij,hwj->hwi", np.linalg.inv(K), pix) * gt[..., None]
    X_w = np.einsum("ij,hwj->hwi", R[ref].T, X_cam - t[ref])
    n_cover = np.zeros((H, W), np.int32)
    for v in src_views:
        Xv = np.einsum("ij,hwj->hwi", R[v], X_w) + t[v]
        z = Xv[..., 2]
        q = np.einsum("ij,hwj->hwi", K, Xv)
        qx = q[..., 0] / q[..., 2]
        qy = q[..., 1] / q[..., 2]
        inb = ((z > 0) & (qx >= border) & (qx <= W - 1 - border)
               & (qy >= border) & (qy <= H - 1 - border))
        gy = np.clip(np.round(qy).astype(int), 0, H - 1)
        gx = np.clip(np.round(qx).astype(int), 0, W - 1)
        vis = inb & (z <= scene.depth[v][gy, gx] * (1.0 + occl_tol))
        n_cover += vis.astype(np.int32)
    return n_cover


def _write_png_gray(path: Path, img: np.ndarray) -> None:
    """Minimal 8-bit grayscale PNG writer (no external deps)."""
    import struct
    import zlib
    arr = np.clip(img, 0, 255).astype(np.uint8)
    h, w = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    path.write_bytes(png)


def read_png_gray(path: str | Path) -> np.ndarray:
    """Minimal grayscale PNG reader for files written by _write_png_gray."""
    import struct
    import zlib
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, w, h, idat = 8, 0, 0, b""
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack_from(">IIBB", payload)
            assert bit_depth == 8 and color_type == 0, "only 8-bit gray"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w + 1
    rows = []
    prev = np.zeros(w, np.int64)
    for i in range(h):
        filt = raw[i * stride]
        line = np.frombuffer(raw[i * stride + 1:(i + 1) * stride],
                             np.uint8).astype(np.int64)
        if filt == 0:
            row = line
        elif filt == 2:  # up
            row = (line + prev) % 256
        elif filt == 1:  # sub
            row = np.cumsum(line) % 256  # only valid per-pixel; do loop
            row = _png_defilter_sub(line)
        else:
            row = _png_defilter_general(filt, line, prev)
        rows.append(row)
        prev = row
    return np.stack(rows).astype(np.float32)


def _png_defilter_sub(line: np.ndarray) -> np.ndarray:
    out = np.zeros_like(line)
    acc = 0
    for i, v in enumerate(line):
        acc = (acc + v) % 256
        out[i] = acc
    return out


def _png_defilter_general(filt: int, line: np.ndarray,
                          prev: np.ndarray) -> np.ndarray:
    out = np.zeros_like(line)
    a = 0
    c = 0
    for i, v in enumerate(line):
        b = prev[i]
        if filt == 3:
            pred = (a + b) // 2
        else:  # paeth
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (v + pred) % 256
        a = out[i]
        c = b
    return out


def look_at(C: np.ndarray, target: np.ndarray,
            up=np.array([0.0, -1.0, 0.0])) -> tuple[np.ndarray, np.ndarray]:
    """World->camera rotation R and translation t = -R C for a camera at C
    looking at `target` (z forward, y down — image convention)."""
    z = target - C
    z = z / np.linalg.norm(z)
    x = np.cross(-up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ C


def _render_view(R: np.ndarray, t: np.ndarray, K: np.ndarray, rects,
                 cyls, height: int, width: int, seed: int):
    """Ray-cast one view: (image before noise, camera-frame depth with inf
    for a miss, world normals, textureless mask)."""
    f = K[0, 0]
    xx, yy = np.meshgrid(np.arange(width) + 0.0, np.arange(height) + 0.0)
    pix = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    K_inv = np.linalg.inv(K)
    C = -R.T @ t
    dirs = np.einsum("ij,hwj->hwi", R.T @ K_inv, pix)  # ray dirs, world
    best_s = np.full((height, width), np.inf)
    tex_val = np.zeros((height, width))
    hit_n = np.zeros((height, width, 3))
    hit_weak = np.zeros((height, width), bool)
    for rect in rects:
        n = rect.normal
        denom = dirs @ n
        s = ((rect.origin - C) @ n) / np.where(np.abs(denom) < 1e-12,
                                               np.nan, denom)
        X = C + s[..., None] * dirs
        rel = X - rect.origin
        u = rel @ rect.eu / (rect.eu @ rect.eu)
        w_ = rel @ rect.ev / (rect.ev @ rect.ev)
        valid = (np.isfinite(s) & (s > 0) & (u >= 0) & (u <= 1)
                 & (w_ >= 0) & (w_ <= 1) & (s < best_s))
        if rect.textured:
            # Resolution-matched texture: extend the octave ladder so
            # the finest octave has a ~2-4 px wavelength at THIS
            # render size, with a 0.7 persistence (flatter spectrum,
            # like real photographs). A fixed 4-octave/0.5 spectrum
            # becomes per-pixel smooth at >=1K renders, and the
            # Roberts weak-texture detector (correctly, per its
            # reference thresholds) then flags most of the image as
            # textureless — which is scene unrealism, not detector
            # or engine error.
            px_per_unit = f / 5.0      # typical scene depth ~5
            octs = int(np.clip(np.ceil(np.log2(
                max(px_per_unit / 3.0, 4.0) / 2.0)) + 1, 4, 9))
            val = 0.15 + 0.7 * value_noise(X, seed=seed, octaves=octs,
                                           persistence=0.7)
        else:
            val = np.full(s.shape, rect.albedo)
        in_patch = np.zeros(s.shape, bool)
        if rect.flat_patch is not None:
            # Soft-edged textureless patch: texture amplitude ramps to
            # zero toward the core (real weak regions fade gradually,
            # which is what gives TSAR's region RANSAC a halo of
            # matchable, coplanar support around the flat core).
            u0, u1, v0, v1 = rect.flat_patch
            margin = 0.25
            du = (np.minimum(u - u0, u1 - u) / (u1 - u0)) / margin
            dv = (np.minimum(w_ - v0, v1 - w_) / (v1 - v0)) / margin
            inside = np.minimum(du, dv)      # <0 outside, >=1 core
            tex_w = np.clip(1.0 - inside, 0.0, 1.0)  # texture weight
            tex_w = tex_w * tex_w * (3 - 2 * tex_w)
            val = val * tex_w + rect.albedo * (1.0 - tex_w)
            in_patch = inside > 0.55  # flat core (texture < ~3%)
        best_s = np.where(valid, s, best_s)
        tex_val = np.where(valid, val, tex_val)
        hit_n = np.where(valid[..., None], n, hit_n)
        hit_weak = np.where(valid, (not rect.textured) | in_patch,
                            hit_weak)
    for cyl in cyls:
        av = cyl.axis / np.linalg.norm(cyl.axis)
        oc = C - cyl.c0
        d_perp = dirs - (dirs @ av)[..., None] * av
        o_perp = oc - (oc @ av) * av
        a = np.sum(d_perp * d_perp, axis=-1)
        bq = 2.0 * (d_perp @ o_perp)
        cq = o_perp @ o_perp - cyl.radius ** 2
        disc = bq * bq - 4.0 * a * cq
        ok_d = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.where(ok_d, disc, 0.0))
        s = np.where(ok_d, (-bq - sq) / (2 * np.where(a > 1e-12, a, 1)),
                     np.nan)                       # near (front) hit
        X = C + s[..., None] * dirs
        rel_ax = (X - cyl.c0) @ av
        w_vec = (X - cyl.c0) - rel_ax[..., None] * av
        n_map = w_vec / np.maximum(
            np.linalg.norm(w_vec, axis=-1, keepdims=True), 1e-12)
        fd = cyl.face_dir / np.linalg.norm(cyl.face_dir)
        cosang = n_map @ fd
        cos_half = np.cos(np.deg2rad(cyl.span_deg / 2))
        valid = (np.isfinite(s) & (s > 0) & ok_d
                 & (rel_ax >= 0) & (rel_ax <= cyl.height)
                 & (cosang >= cos_half) & (s < best_s))
        # Texture ramps in from the rim (angular + height edges) so
        # the weak core has a matchable textured halo.
        ang_in = (cosang - cos_half) / (1.0 - cos_half)   # 0 rim,1 apex
        h_in = np.minimum(rel_ax, cyl.height - rel_ax) / cyl.height
        inside = np.minimum(ang_in / cyl.rim,
                            h_in / (cyl.rim * 0.5))
        tex_w = np.clip(1.0 - inside, 0.0, 1.0)
        tex_w = tex_w * tex_w * (3 - 2 * tex_w)
        tex = 0.15 + 0.7 * value_noise(X, seed=seed, octaves=6,
                                       persistence=0.7)
        val = tex * tex_w + cyl.albedo * (1.0 - tex_w)
        in_core = inside > 0.55
        best_s = np.where(valid, s, best_s)
        tex_val = np.where(valid, val, tex_val)
        hit_n = np.where(valid[..., None], n_map, hit_n)
        hit_weak = np.where(valid, in_core, hit_weak)
    # Camera-frame depth = z component of R X + t.
    X = C + best_s[..., None] * dirs
    z = (np.einsum("ij,hwj->hwi", R, X) + t)[..., 2]
    img = np.clip(tex_val * 255.0, 0, 255)
    return (img, np.where(np.isfinite(best_s), z, np.inf), hit_n, hit_weak)


def make_scene(height: int = 96, width: int = 128, num_views: int = 5,
               seed: int = 0, weak_fraction: float = 0.25,
               arc_radius: float = 4.0, arc_span_deg: float = 40.0,
               noise_sigma: float = 0.0, curved_weak: bool = False,
               geometry_jitter: float = 0.0,
               workers: int = 1) -> SyntheticScene:
    """Build a fronto-ish scene: a large slanted background plane, a tilted
    foreground rectangle, and a textureless rectangle covering roughly
    `weak_fraction` of the image (exercises the TSAR weak-region path).

    curved_weak=True swaps the planar textureless patch for a bulging
    textureless cylinder section (Cyl3D) — the case where region RANSAC's
    single plane is wrong by construction. geometry_jitter > 0 perturbs
    rect origins/edges and the weak-patch placement with seed-derived
    noise (scene diversity across seeds; 0 keeps the bench/validation
    geometry bit-stable for seed continuity). workers > 1 renders the
    views in that many spawned processes, with the same result."""
    rng = np.random.default_rng(seed)
    f = 1.2 * width
    K = np.array([[f, 0, width / 2.0],
                  [0, f, height / 2.0],
                  [0, 0, 1.0]])

    wf = max(0.05, min(weak_fraction, 0.9))
    patch = (0.55, 0.55 + 0.35 * wf * 4, 0.30, 0.30 + 0.30 * wf * 4)
    if geometry_jitter > 0:
        # Shift the weak patch as a unit, bounded so it stays inside the
        # camera arc's visible band of the background plane.
        g = geometry_jitter
        du, dv = rng.uniform(-0.08, 0.08, 2) * g
        patch = (patch[0] + du, patch[1] + du,
                 np.clip(patch[2] + dv, 0.3, 0.65),
                 np.clip(patch[3] + dv, 0.3, 0.65))
    rects = [
        # Background: big plane at z≈6, slightly tilted, with an embedded
        # textureless (constant-albedo) patch — the TSAR weak-region case.
        Rect3D(origin=np.array([-8.0, -6.0, 6.5]),
               eu=np.array([16.0, 0.0, 1.2]),
               ev=np.array([0.0, 12.0, -0.8]), textured=True,
               albedo=0.62,
               flat_patch=None if curved_weak else patch),
        # Foreground tilted rectangle (adds a depth discontinuity).
        Rect3D(origin=np.array([-1.6, -1.4, 4.2]),
               eu=np.array([1.8, 0.0, 0.7]),
               ev=np.array([0.0, 1.6, -0.3]), textured=True),
    ]
    if geometry_jitter > 0:
        g = geometry_jitter
        for r in rects:
            r.origin = r.origin + rng.uniform(-0.3, 0.3, 3) * g
            r.eu = r.eu + rng.uniform(-0.15, 0.15, 3) * g
            r.ev = r.ev + rng.uniform(-0.15, 0.15, 3) * g
    cyls = []
    if curved_weak:
        # Bare column bulging toward the cameras: textureless curved
        # surface in front of the textured background.
        c0 = np.array([0.9, -2.2, 5.9])
        if geometry_jitter > 0:
            c0 = c0 + rng.uniform(-0.3, 0.3, 3) * geometry_jitter
        cyls.append(Cyl3D(c0=c0, axis=np.array([0.0, 1.0, 0.0]),
                          radius=1.1, height=4.4,
                          face_dir=np.array([0.0, 0.0, -1.0]),
                          span_deg=110.0, albedo=0.55))

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

    V = num_views
    images = np.zeros((V, height, width), np.float32)
    depth = np.full((V, height, width), np.inf, np.float32)
    normal_world = np.zeros((V, height, width, 3), np.float32)
    weak_mask = np.zeros((V, height, width), bool)
    jobs = [(Rs[v], ts[v], K, rects, cyls, height, width, seed)
            for v in range(V)]
    if workers > 1:
        # Spawned processes: the views are independent and the render is
        # numpy in float64, so every view comes out bit for bit the same.
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=min(workers, V),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            views = list(ex.map(_render_view, *zip(*jobs)))
    else:
        views = [_render_view(*job) for job in jobs]
    for v, (img, z, hit_n, hit_weak) in enumerate(views):
        if noise_sigma > 0:
            img = np.clip(img + rng.normal(0, noise_sigma, img.shape), 0, 255)
        images[v] = img
        depth[v] = z
        normal_world[v] = hit_n
        weak_mask[v] = hit_weak

    # Camera-frame normals, oriented toward the camera.
    normal_cam = np.einsum("vij,vhwj->vhwi", np.stack(Rs), normal_world)
    flip = (normal_cam[..., 2:3] > 0)
    normal_cam = np.where(flip, -normal_cam, normal_cam)

    finite = depth[np.isfinite(depth)]
    dmin, dmax = float(finite.min()), float(finite.max())
    margin = 0.15 * (dmax - dmin)
    return SyntheticScene(
        images=images, P=np.stack(Ps), K=K, R=np.stack(Rs), t=np.stack(ts),
        depth=depth, normal_cam=normal_cam.astype(np.float32),
        normal_world=normal_world.astype(np.float32), weak_mask=weak_mask,
        depth_min=max(1e-3, dmin - margin), depth_max=dmax + margin)


def gt_cloud(scene: SyntheticScene, stride: int = 4) -> np.ndarray:
    """GT point cloud (N, 3): every view's GT depth backprojected into
    the world frame, every `stride`-th pixel (the cloud that
    scripts/validate_synthetic.py scores fused scenes against)."""
    Kinv = np.linalg.inv(scene.K)
    pts = []
    for v in range(scene.depth.shape[0]):
        d = scene.depth[v][::stride, ::stride]
        yy, xx = np.nonzero(np.isfinite(d))
        p = np.stack([xx * stride, yy * stride, np.ones_like(xx)], 0)
        cam = (Kinv @ p) * d[yy, xx]
        pts.append((scene.R[v].T @ (cam - scene.t[v][:, None])).T)
    return np.concatenate(pts)
