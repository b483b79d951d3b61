"""The benchmark's own writers of a scene's on-disk contract, the one
``pipeline.load_scene`` reads:

    <root>/images/<name>.pfm        float32 gray, rows bottom to top
    <root>/cams/<name>_cam.txt      extrinsic 4x4, intrinsic 3x3, depth
                                    min, interval, count, max
    <root>/pair.txt                 ranked source views a reference

They are the harness's, not the program's, so that a change to the
program's writers cannot change what the benchmark feeds it. Numbers are
written with 17 significant digits, so that the cameras read back equal
to the bit to the rendered ones.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

DEPTH_PLANES = 192


def write_pfm(path: Path, img: np.ndarray) -> None:
    """A one-channel little-endian PFM of `img` (H, W) as float32."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"Pf\n{w} {h}\n-1.0\n".encode())
        fh.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def _row(values) -> str:
    return " ".join(repr(float(v)) for v in values)


def write_cam(path: Path, K: np.ndarray, R: np.ndarray, t: np.ndarray,
              depth_min: float, depth_max: float) -> None:
    E = np.eye(4)
    E[:3, :3], E[:3, 3] = R, t
    interval = (depth_max - depth_min) / DEPTH_PLANES
    lines = (["extrinsic"] + [_row(r) for r in E] + ["", "intrinsic"]
             + [_row(r) for r in K] + ["", _row(
                 (depth_min, interval, DEPTH_PLANES, depth_max)), ""])
    Path(path).write_text("\n".join(lines))


def write_pair(path: Path, pair: dict[int, list[tuple[int, float]]]) -> None:
    lines = [str(len(pair))]
    for v in sorted(pair):
        lines.append(str(v))
        lines.append(" ".join([str(len(pair[v]))] + [
            f"{j} {score!r}" for j, score in pair[v]]))
    Path(path).write_text("\n".join(lines) + "\n")


def write_scene(root: Path, names: list[str], images: np.ndarray, K, R, t,
                depth_min: float, depth_max: float, pair: dict) -> int:
    """Every view's image and camera and the pair file under `root`;
    returns the bytes written."""
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "cams").mkdir(parents=True, exist_ok=True)
    for v, name in enumerate(names):
        write_pfm(root / "images" / f"{name}.pfm", images[v])
        write_cam(root / "cams" / f"{name}_cam.txt", K, R[v], t[v],
                  depth_min, depth_max)
    write_pair(root / "pair.txt", pair)
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
