"""PFM image codec (reference: readPfm, fileIoUtils.h:383-488).

Standard Portable FloatMap: 'Pf' (gray) / 'PF' (color) header, width
height, scale (sign encodes endianness), then rows bottom-to-top.

The port's own copy of ``tsar_mvs_tpu.utils.pfm``
(same semantics, no jax).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_pfm(path: str | Path) -> np.ndarray:
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic not in (b"Pf", b"PF"):
            raise ValueError(f"{path}: not a PFM file (magic {magic!r})")
        channels = 3 if magic == b"PF" else 1
        dims = fh.readline().split()
        while dims and dims[0].startswith(b"#"):
            dims = fh.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(fh.readline().strip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(fh.read(), endian + "f4", count=w * h * channels)
    img = data.reshape(h, w, channels)[::-1]  # bottom-to-top storage
    return img[..., 0] if channels == 1 else img


def write_pfm(path: str | Path, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        magic, channels = b"Pf", 1
    elif img.ndim == 3 and img.shape[2] == 3:
        magic, channels = b"PF", 3
    else:
        raise ValueError(f"PFM supports (h,w) or (h,w,3), got {img.shape}")
    with open(path, "wb") as fh:
        fh.write(magic + b"\n")
        fh.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        fh.write(b"-1.0\n")  # little endian
        fh.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())
