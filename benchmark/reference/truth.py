"""Plain reference of what a view's written maps should hold.

The benchmark's scene has exact geometry, so the reference of a depth
map is the true camera-frame depth of the surface each pixel sees and
the reference of a normal map its true world normal, facing the camera.
This module works out, in plain PyTorch float64 from the scene's own
cameras and ground truth, which pixels any multi-view method can match
(seen by at least one of the view's sources, not occluded there), reads
the program's ``.dmb`` files back with its own reader, and measures the
maps against the truth. It imports nothing of the program.

The accuracy arithmetic (`rel_error`, the share within 2%, the
matchable pixels) is a copy of the port's ``bench.accuracy``,
``bench.matchable_pixels`` and ``utils.synthetic.source_coverage``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

F64 = torch.float64
_DMB_HEADER = struct.Struct("<iiii")


def read_dmb(path: str | Path) -> np.ndarray:
    """A float32 .dmb (header of four little-endian int32 type, h, w, nb;
    type 1 is float32) as an (h, w) or (h, w, nb) array."""
    data = Path(path).read_bytes()
    tag, h, w, nb = _DMB_HEADER.unpack_from(data, 0)
    if tag != 1:
        raise ValueError(f"{path}: dmb type {tag}, not float32")
    arr = np.frombuffer(data, np.float32, count=h * w * nb,
                        offset=_DMB_HEADER.size).reshape(h, w, nb)
    return arr[..., 0] if nb == 1 else arr


def write_dmb(path: str | Path, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, np.float32)
    h, w = arr.shape[:2]
    nb = 1 if arr.ndim == 2 else arr.shape[2]
    with open(path, "wb") as fh:
        fh.write(_DMB_HEADER.pack(1, h, w, nb))
        fh.write(arr.tobytes())


def write_png_gray(path: str | Path, img: np.ndarray) -> None:
    """8-bit grayscale PNG, no filter (zlib level 1)."""
    import zlib
    arr = np.clip(img, 0, 255).astype(np.uint8)
    h, w = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr], 1).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(raw, 1))
                           + chunk(b"IEND", b""))


def source_coverage(scene, ref: int, src_views, border: int = 1,
                    occl_tol: float = 0.01) -> torch.Tensor:
    """(H, W) count of sources in which the reference pixel's true surface
    point projects inside the image and is not occluded (by the source's
    own true depth)."""
    depth = scene.depth
    dev = depth.device
    H, W = depth.shape[1:]
    K = torch.tensor(scene.K, dtype=F64, device=dev)
    Kinv = torch.linalg.inv(K)
    R = torch.tensor(scene.R, dtype=F64, device=dev)
    t = torch.tensor(scene.t, dtype=F64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=F64, device=dev),
                            torch.arange(W, dtype=F64, device=dev),
                            indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    X_cam = (pix @ Kinv.T) * depth[ref][..., None]
    X_w = (X_cam - t[ref]) @ R[ref]
    n_cover = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for v in src_views:
        Xv = X_w @ R[v].T + t[v]
        z = Xv[..., 2]
        q = Xv @ K.T
        qx, qy = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
        inb = ((z > 0) & (qx >= border) & (qx <= W - 1 - border)
               & (qy >= border) & (qy <= H - 1 - border))
        gy = torch.clamp(torch.nan_to_num(torch.round(qy)), 0, H - 1).long()
        gx = torch.clamp(torch.nan_to_num(torch.round(qx)), 0, W - 1).long()
        vis = inb & (z <= depth[v][gy, gx] * (1.0 + occl_tol))
        n_cover += vis.to(torch.int32)
    return n_cover


def facing_normals(scene, ref: int) -> torch.Tensor:
    """(H, W, 3) true world normals of view `ref`, turned to face its
    camera, on the device of the scene's depth."""
    dev = scene.depth.device
    n = scene.normal_world[ref].to(dev)
    H, W = n.shape[:2]
    Minv = torch.tensor(scene.R[ref].T @ np.linalg.inv(scene.K), dtype=F64,
                        device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=F64, device=dev),
                            torch.arange(W, dtype=F64, device=dev),
                            indexing="ij")
    ray = torch.stack([xx, yy, torch.ones_like(xx)], -1) @ Minv.T
    flip = (n * ray).sum(-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


class ViewTruth:
    """What the reference knows of one view: true depth, facing normals,
    and the pixel sets the check measures over."""

    def __init__(self, scene, ref: int, src_views):
        gt = scene.depth[ref]
        finite = torch.isfinite(gt)
        seen = finite & (source_coverage(scene, ref, src_views) >= 1)
        weak = scene.weak_mask[ref].to(gt.device)
        self.depth = gt
        self.normal = facing_normals(scene, ref)
        self.seen = seen                  # finite truth, >= 1 source sees it
        self.textured = seen & ~weak      # the matchable textured pixels
        self.weak = seen & weak           # the matchable textureless core


def rel_error(truth: ViewTruth, depth: torch.Tensor) -> torch.Tensor:
    """|depth - true depth| / true depth (inf where the written depth is
    not finite; the divisor 1 where the truth is not finite)."""
    gt = truth.depth
    err = (depth.to(F64) - gt).abs() / torch.where(torch.isfinite(gt), gt,
                                                   1.0)
    return torch.where(torch.isfinite(depth), err, torch.inf)


def view_measures(truth: ViewTruth, depth: torch.Tensor,
                  normal: torch.Tensor) -> dict:
    """One view's maps against the truth: the share of seen pixels within
    2% (`acc2`, the end-to-end `depth_acc2`); the share of textured pixels
    off by 2% or more, and the median and the 25th percentile of their
    relative error; the same share on the weak pixels (None where the
    view sees none); the median angle in degrees between the written and
    the true normal on the textured pixels; and the share of the seen
    pixels with a positive depth whose written float32 depth lies on the
    bfloat16 grid (its low 16 bits zero: 2^-16 of them by chance)."""
    rel = rel_error(truth, depth)
    n = normal.to(F64)
    cos = (n * truth.normal).sum(-1).abs() / torch.clamp(
        torch.linalg.vector_norm(n, dim=-1), min=1e-30)
    ang = torch.rad2deg(torch.arccos(torch.clamp(
        torch.nan_to_num(cos, nan=-1.0), -1.0, 1.0)))

    def share_bad(sel):
        return float((rel[sel] >= 0.02).to(F64).mean()) if bool(
            sel.any()) else None

    def quantile(sel, q):
        return float(torch.quantile(rel[sel].clamp(max=1e30).float(), q)) \
            if bool(sel.any()) else None

    tex = truth.textured
    return {"acc2": 1.0 - (share_bad(truth.seen) or 0.0),
            "tex_bad2": share_bad(tex) or 0.0,
            "weak_bad2": share_bad(truth.weak),
            "tex_err_med": quantile(tex, 0.5),
            "tex_err_p25": quantile(tex, 0.25),
            "tex_nrm_med_deg": float(torch.quantile(ang[tex].float(), 0.5)),
            "bf16_grid": share_on_bf16_grid(depth, truth.seen)}


def share_on_bf16_grid(depth: torch.Tensor, sel: torch.Tensor) -> float:
    """The share of the `sel` pixels with a finite positive float32 depth
    whose low 16 bits are zero, so that bfloat16 holds it exactly."""
    d = depth.to(torch.float32)
    sel = sel & torch.isfinite(d) & (d > 0)
    if not bool(sel.any()):
        return 0.0
    low = d.contiguous().view(torch.int32) & 0xFFFF
    return float((low[sel] == 0).to(F64).mean())
