"""Visualization artifacts.

Equivalents of the reference's debug/display outputs (SURVEY.md §2 #21):

* ``normals_for_display``  — normal map -> RGB image (getNormalsForDisplay,
  displayUtils.h:34-76), with ``add_sphere_legend`` reproducing the
  normal-sphere legend inset (main.cpp:1321-1341).
* ``disparity_for_display`` — depth/disparity -> normalized grayscale
  (getDisparityForDisplay).
* ``confidence_for_display`` — [0,1] map -> grayscale.
* ``write_parameters_file`` — full parameter dump next to the results
  (writeParametersToFile, fileIoUtils.h:184-258).

PNG writing uses PIL when present (baked into the image) and falls back
to the repo's minimal grayscale writer.

The port's own copy of ``tsar_mvs_tpu.utils.display``
(same semantics, no jax).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


def normals_for_display(normal: np.ndarray) -> np.ndarray:
    """(H, W, 3) unit normals -> (H, W, 3) uint8 RGB: channel c =
    (n_c + 1)/2 * 255; zero normals render black."""
    n = np.asarray(normal, np.float32)
    rgb = np.clip((n + 1.0) * 0.5 * 255.0, 0, 255).astype(np.uint8)
    invalid = np.linalg.norm(n, axis=-1) < 1e-6
    rgb[invalid] = 0
    return rgb


def sphere_legend(size: int = 100) -> np.ndarray:
    """Rendered hemisphere whose surface normals use the same color
    coding — the legend inset the reference stamps into the normal PNG
    (main.cpp:1321-1341)."""
    r = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size]
    x = (xx - r) / r
    y = (yy - r) / r
    inside = x * x + y * y <= 1.0
    z = np.sqrt(np.maximum(1.0 - x * x - y * y, 0.0))
    # Camera-facing hemisphere: normals point toward the viewer (-z),
    # matching the rebased-ref-frame convention.
    n = np.stack([x, y, -z], axis=-1)
    img = normals_for_display(n)
    img[~inside] = 255
    return img


def add_sphere_legend(rgb: np.ndarray, size: int = 100) -> np.ndarray:
    """Stamp the sphere legend into the lower-right corner."""
    out = np.array(rgb, copy=True)
    h, w = out.shape[:2]
    s = min(size, h, w)
    out[h - s:, w - s:] = sphere_legend(s)
    return out


def disparity_for_display(disp: np.ndarray,
                          lo: float | None = None,
                          hi: float | None = None) -> np.ndarray:
    """Depth/disparity -> uint8 grayscale, valid-range normalized
    (getDisparityForDisplay contract). Invalid (<=0 / non-finite) pixels
    render black."""
    d = np.asarray(disp, np.float64)
    valid = np.isfinite(d) & (d > 0)
    if not valid.any():
        return np.zeros(d.shape, np.uint8)
    lo = float(d[valid].min()) if lo is None else lo
    hi = float(d[valid].max()) if hi is None else hi
    scale = 255.0 / max(hi - lo, 1e-12)
    out = np.clip((d - lo) * scale, 0, 255).astype(np.uint8)
    out[~valid] = 0
    return out


def confidence_for_display(conf: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(conf, np.float64) * 255.0, 0,
                   255).astype(np.uint8)


def slic_boundaries_for_display(labels: np.ndarray,
                                gray: np.ndarray) -> np.ndarray:
    """Superpixel boundary overlay (Draw_Segmentation_Result_device,
    gSLICr_seg_engine_GPU.cu:365-379: boundary pixels painted red over
    the input). Grayscale writer fallback: boundaries go white."""
    lab = np.asarray(labels)
    H, W = lab.shape
    edge = np.zeros((H, W), bool)
    edge[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    edge[:-1, :] |= lab[:-1, :] != lab[1:, :]
    g = np.clip(np.asarray(gray, np.float64), 0, 255).astype(np.uint8)
    g = g[:H, :W]
    rgb = np.stack([g, g, g], axis=-1)
    rgb[edge] = (255, 0, 0)
    return rgb


def write_png(path: str | Path, img: np.ndarray) -> bool:
    """Write a uint8 grayscale or RGB image. Returns False when no
    writer is available (PIL absent and image is RGB)."""
    path = Path(path)
    img = np.asarray(img)
    try:
        from PIL import Image
    except ImportError:
        if img.ndim == 2:
            from tsar_mvs_tpu_torch.utils.synthetic import _write_png_gray
            _write_png_gray(path, img)
            return True
        return False
    Image.fromarray(img).save(path)
    return True


def write_parameters_file(path: str | Path, params,
                          extra: dict | None = None) -> None:
    """Dump every parameter field as `name = value` lines
    (writeParametersToFile, fileIoUtils.h:184-258)."""
    lines = [f"# {type(params).__name__}"]
    for f in dataclasses.fields(params):
        lines.append(f"{f.name} = {getattr(params, f.name)}")
    for k, v in (extra or {}).items():
        lines.append(f"{k} = {v}")
    Path(path).write_text("\n".join(lines) + "\n")
