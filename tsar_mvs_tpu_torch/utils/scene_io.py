"""Scene-level readers/writers: MVSNet-style cams + pair.txt, Strecha .P.

File contracts (reference):
* cams/xxxxxxxx_cam.txt — `extrinsic` keyword, 3 rows of [R|t], a fourth
  homogeneous row, `intrinsic` keyword, 3x3 K, then
  `depth_min interval depth_num depth_max` (readKRtFileMiddlebury,
  fileIoUtils.h:111-163).
* pair.txt — first line: number of views; then per view a line with the
  view id and a line `k id1 score1 id2 score2 ...`
  (main.cpp:1345-1384).
* Strecha/PMVS .P files — 3 rows of a 3x4 P matrix
  (readPFileStrechaPmvs, fileIoUtils.h:83-110).

The port's own copy of ``tsar_mvs_tpu.utils.scene_io``
(same semantics, no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class CamFile:
    R: np.ndarray            # (3, 3)
    t: np.ndarray            # (3,)
    K: np.ndarray            # (3, 3)
    depth_min: float = 0.0
    depth_interval: float = 0.0
    depth_num: float = 0.0
    depth_max: float = 0.0

    @property
    def P(self) -> np.ndarray:
        return self.K @ np.concatenate([self.R, self.t[:, None]], axis=1)


def read_cam_file(path: str | Path) -> CamFile:
    tokens = Path(path).read_text().split()
    # Strip keywords, keep numerics in order.
    nums = [float(t) for t in tokens if _is_number(t)]
    # extrinsic 4x4 (16) + intrinsic 3x3 (9) + up to 4 depth values.
    if len(nums) < 25:
        raise ValueError(f"{path}: expected >=25 numbers, got {len(nums)}")
    E = np.array(nums[:16]).reshape(4, 4)
    K = np.array(nums[16:25]).reshape(3, 3)
    depth = (nums[25:29] + [0.0, 0.0, 0.0, 0.0])[:4]
    return CamFile(R=E[:3, :3], t=E[:3, 3], K=K,
                   depth_min=depth[0], depth_interval=depth[1],
                   depth_num=depth[2], depth_max=depth[3])


def write_cam_file(path: str | Path, cam: CamFile) -> None:
    E = np.eye(4)
    E[:3, :3] = cam.R
    E[:3, 3] = cam.t
    lines = ["extrinsic"]
    lines += [" ".join(f"{v:.9g}" for v in row) for row in E]
    lines += ["", "intrinsic"]
    lines += [" ".join(f"{v:.9g}" for v in row) for row in cam.K]
    lines += ["", f"{cam.depth_min:.9g} {cam.depth_interval:.9g} "
                  f"{cam.depth_num:.9g} {cam.depth_max:.9g}", ""]
    Path(path).write_text("\n".join(lines))


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


@dataclass
class PairFile:
    """pair.txt content: per-view ranked source views with scores."""
    neighbors: dict[int, list[tuple[int, float]]] = field(default_factory=dict)

    def view_selection(self, ref_id: int, max_views: int | None = None
                       ) -> list[int]:
        """Source-view indices for ref view `ref_id`, in the *image list
        order the reference uses*: the per-view image list is
        [ref, all others in id order], so a pair-id <= ref shifts +1 and a
        pair-id > ref stays (main.cpp:1366-1377 — ids >? ref keep their
        index because ref moved to slot 0)."""
        sel = []
        for vid, _score in self.neighbors.get(ref_id, []):
            sel.append(vid if vid > ref_id else vid + 1)
        if max_views is not None:
            sel = sel[:max_views]
        return sel

    def source_ids(self, ref_id: int, max_views: int | None = None
                   ) -> list[int]:
        """Raw neighbor view ids (dataset numbering, no list reordering)."""
        ids = [vid for vid, _ in self.neighbors.get(ref_id, [])]
        return ids if max_views is None else ids[:max_views]


def read_pair_file(path: str | Path) -> PairFile:
    tokens = Path(path).read_text().split()
    it = iter(tokens)
    num_views = int(next(it))
    neighbors: dict[int, list[tuple[int, float]]] = {}
    for _ in range(num_views):
        vid = int(next(it))
        k = int(next(it))
        entries = []
        for _ in range(k):
            nid = int(next(it))
            score = float(next(it))
            entries.append((nid, score))
        neighbors[vid] = entries
    return PairFile(neighbors=neighbors)


def write_pair_file(path: str | Path, pair: PairFile) -> None:
    lines = [str(len(pair.neighbors))]
    for vid in sorted(pair.neighbors):
        lines.append(str(vid))
        entries = pair.neighbors[vid]
        lines.append(" ".join([str(len(entries))] +
                              [f"{nid} {score:.6g}" for nid, score in entries]))
    Path(path).write_text("\n".join(lines) + "\n")


def read_kitti_calib(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """KITTI calib file: first two lines hold P0 and P1 as 12 numbers
    (readCalibFileKitti, fileIoUtils.h:44-54; leading 'P0:'/'P1:' tags
    are skipped like the reference's strtok filter)."""
    lines = Path(path).read_text().splitlines()
    Ps = []
    for line in lines:
        vals = [float(t) for t in line.replace(":", " ").split()
                if _is_number(t)]
        if len(vals) >= 12:
            Ps.append(np.array(vals[:12]).reshape(3, 4))
        if len(Ps) == 2:
            break
    if len(Ps) != 2:
        raise ValueError(f"{path}: expected two projection-matrix lines")
    return Ps[0], Ps[1]


def read_bounding_volume(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Bounding volume file: two lines with the bottom-left and top-right
    3-D corners (readBoundingVolume, fileIoUtils.h:56-68)."""
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    bl = np.array([float(t) for t in lines[0].split()[:3]])
    tr = np.array([float(t) for t in lines[1].split()[:3]])
    return bl, tr


def read_p_file(path: str | Path) -> np.ndarray:
    """Strecha/PMVS 3x4 P matrix, one row per line
    (fileIoUtils.h:83-110). Skips a leading 'CONTOUR' line if present."""
    rows = []
    for line in Path(path).read_text().splitlines():
        vals = [float(t) for t in line.split() if _is_number(t)]
        if vals:
            rows.extend(vals)
    P = np.array(rows[:12]).reshape(3, 4)
    return P
