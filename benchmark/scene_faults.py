"""Faults planted in the program on the scene path, in a rank process, for
the readings of the scene cells' limits (``benchmark/calibrate_scene.py``)
and for their tests. `plant(name, rank, world)` plants one and returns
the call that takes it out again.

On the maps (every rank; ``parallel/scene_sharded.py`` calls the
``models/tsar`` stages through the module, so the planting functions of
``calibrate.py`` apply as they do on the view path):

- ``fill_offset``: the fill writes its region planes' depth 5% long;
- ``fill_skipped``: the fill returns the state unchanged;
- ``depth_long``: `finalize_stage` returns the depth 5% long;
- ``normals_camera``: phase E returns the normals in each reference
  camera's frame, not the world's (the sharded path turns them itself,
  so `calibrate.normals_camera` does not reach it).

On the fusion (rank 0, which fuses):

- ``points_long``: every fused point 5% farther from the camera of the
  view that emitted it;
- ``views_dropped``: the points of every second view (odd ids) left out;
- ``fusion_skipped``: `fuse_scene` writes no cloud.

Across ranks:

- ``maps_not_shared``: the last rank writes none of its views' maps, so
  its share of the scene never reaches rank 0's fusion;
- ``rank_raises``: the last rank raises in `process_scene`.
"""

from __future__ import annotations

import dataclasses

from benchmark import calibrate


def _swap(module, attr: str, replacement):
    real = getattr(module, attr)
    setattr(module, attr, replacement(real))
    return lambda: setattr(module, attr, real)


def _normals_camera(real):
    import torch

    def planted(*a, **k):
        states, disps, rels, depths, _ = real(*a, **k)
        return states, disps, rels, depths, torch.stack(
            [st.normal for st in states]).to(depths.dtype)
    return planted


def _points_long(real):
    import numpy as np

    def planted(depths, normals, cams, gray, fp):
        cloud = real(depths, normals, cams, gray, fp)
        C = cams.C.cpu().numpy().astype(np.float64)[cloud.view_of]
        pts = C + 1.05 * (cloud.points.astype(np.float64) - C)
        return dataclasses.replace(cloud, points=pts.astype(np.float32))
    return planted


def _views_dropped(real):
    def planted(*a, **k):
        cloud = real(*a, **k)
        keep = cloud.view_of % 2 == 0
        return dataclasses.replace(
            cloud, points=cloud.points[keep], normals=cloud.normals[keep],
            colors=cloud.colors[keep], view_of=cloud.view_of[keep])
    return planted


def _fusion_skipped(real):
    def planted(scene_root, *a, **k):
        from pathlib import Path
        return Path(scene_root) / "results" / "TSAR_fused.ply"
    return planted


def _raises(real):
    def planted(*a, **k):
        raise RuntimeError("planted fault: this rank raises")
    return planted


class _NoWrites:
    """A stand-in for the `dmb` module that writes nothing."""

    @staticmethod
    def write_dmb(*a, **k) -> None:
        return None


def plant(name: str, rank: int, world: int):
    """Plant fault `name` in this rank's program; returns the undo call
    (a no-op where the fault does not touch this rank)."""
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.models import fusion, tsar
    from tsar_mvs_tpu_torch.parallel import scene_sharded
    last = rank == world - 1
    if name in ("fill_offset", "fill_skipped"):
        return _swap(tsar, "fill_stage", getattr(calibrate, name))
    if name == "depth_long":
        return _swap(tsar, "finalize_stage", calibrate.depth_long)
    if name == "normals_camera":
        return _swap(scene_sharded, "fill_finalize_sharded", _normals_camera)
    if name in ("points_long", "views_dropped"):
        make = _points_long if name == "points_long" else _views_dropped
        return _swap(fusion, "fuse", make) if rank == 0 else _noop
    if name == "fusion_skipped":
        return _swap(pipeline, "fuse_scene", _fusion_skipped) \
            if rank == 0 else _noop
    if name == "maps_not_shared":
        return _swap(scene_sharded, "dmb", lambda real: _NoWrites) \
            if last else _noop
    if name == "rank_raises":
        return _swap(pipeline, "process_scene", _raises) if last else _noop
    raise KeyError(f"no fault {name!r}")


def _noop() -> None:
    return None


MAPS = ("fill_offset", "fill_skipped", "depth_long", "normals_camera")
FUSION = ("points_long", "views_dropped", "fusion_skipped")
NAMES = MAPS + FUSION + ("maps_not_shared", "rank_raises")
