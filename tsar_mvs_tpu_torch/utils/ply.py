"""Binary PLY point-cloud writer/reader.

Writer matches the reference's per-view output layout (storePlyFileBinary,
displayUtils.h:78-159): binary_little_endian, per vertex float x y z nx ny
nz + uchar r g b. Vectorized numpy instead of the reference's per-pixel
OpenMP loop.

The port's own copy of ``tsar_mvs_tpu.utils.ply``
(same semantics, no jax).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_VERTEX_DTYPE = np.dtype([
    ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
    ("red", "u1"), ("green", "u1"), ("blue", "u1"),
])


def write_ply(path: str | Path, points: np.ndarray, normals: np.ndarray,
              colors: np.ndarray) -> None:
    """points/normals: (N, 3) float; colors: (N,) or (N, 3) uint8."""
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    colors = np.asarray(colors)
    if colors.ndim == 1:
        colors = np.repeat(colors[:, None], 3, axis=1)
    n = points.shape[0]
    # Non-finite points are zeroed like the reference (displayUtils.h:131-135).
    bad = ~np.isfinite(points).all(axis=1)
    points = np.where(bad[:, None], 0.0, points)

    vertices = np.empty(n, _VERTEX_DTYPE)
    vertices["x"], vertices["y"], vertices["z"] = points.T
    vertices["nx"], vertices["ny"], vertices["nz"] = normals.T
    vertices["red"], vertices["green"], vertices["blue"] = \
        colors.astype(np.uint8).T

    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as fh:
        fh.write(header.encode())
        fh.write(vertices.tobytes())


def read_ply(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a PLY written by write_ply -> (points, normals, colors)."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode()
    n = 0
    for line in header.splitlines():
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
    vertices = np.frombuffer(data, _VERTEX_DTYPE, count=n, offset=end)
    points = np.stack([vertices["x"], vertices["y"], vertices["z"]], axis=1)
    normals = np.stack([vertices["nx"], vertices["ny"], vertices["nz"]],
                       axis=1)
    colors = np.stack([vertices["red"], vertices["green"], vertices["blue"]],
                      axis=1)
    return points, normals, colors
