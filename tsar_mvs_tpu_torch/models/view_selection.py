"""View selection (port of ``tsar_mvs_tpu.models.view_selection``; numpy only).

Two paths, mirroring the reference:

* ``select_views_pair``   — the active path: ranked neighbors from a
  MVSNet-style ``pair.txt`` (main.cpp:1345-1384); implemented by
  ``utils.scene_io.PairFile`` and re-exported here.
* ``select_views_angle``  — the legacy geometric path (selectViews,
  main.cpp:1011-1096): keep source cameras whose triangulation angle at
  the scene midpoint lies in [min_angle, max_angle] degrees, then
  randomly downsample to ``max_views``.

The triangulation angle is measured between the rays from the two camera
centers to the point at mid depth-range along the reference principal
axis — small angles give degenerate triangulation, large angles break
NCC photo-consistency.
"""

from __future__ import annotations

import numpy as np

from tsar_mvs_tpu_torch import geometry as geo


def principal_axis(P: np.ndarray) -> np.ndarray:
    """Unit principal axis of a projection matrix (points into the
    scene): det(M) * m3 with M the left 3x3 and m3 its third row."""
    M = np.asarray(P, np.float64)[:, :3]
    axis = np.linalg.det(M) * M[2]
    return axis / np.linalg.norm(axis)


def triangulation_angles(P_list, ref_idx: int,
                         depth_mid: float) -> np.ndarray:
    """Angle (degrees) at the midpoint between the reference ray and each
    camera's ray, for every view (ref's own entry is 0)."""
    centers = np.stack([geo.camera_center(np.asarray(P, np.float64))
                        for P in P_list])
    c_ref = centers[ref_idx]
    X = c_ref + principal_axis(P_list[ref_idx]) * depth_mid

    v_ref = X - c_ref
    v_ref /= np.linalg.norm(v_ref)
    out = np.zeros(len(P_list))
    for i, c in enumerate(centers):
        if i == ref_idx:
            continue
        v = X - c
        n = np.linalg.norm(v)
        if n < 1e-12:
            continue
        cosang = np.clip(np.dot(v / n, v_ref), -1.0, 1.0)
        out[i] = np.degrees(np.arccos(cosang))
    return out


def select_views_angle(P_list, ref_idx: int, depth_min: float,
                       depth_max: float, min_angle: float = 5.0,
                       max_angle: float = 45.0, max_views: int = 14,
                       seed: int = 0) -> list[int]:
    """Legacy angle/baseline view selection (selectViews,
    main.cpp:1011-1096). Returns source view indices into ``P_list``.

    Unlike the reference's ``rand()`` downsample (main.cpp:1086), the
    subsample is seeded for reproducibility (SURVEY.md §7 determinism).
    """
    depth_mid = 0.5 * (depth_min + depth_max)
    ang = triangulation_angles(P_list, ref_idx, depth_mid)
    cand = [i for i in range(len(P_list))
            if i != ref_idx and min_angle <= ang[i] <= max_angle]
    if len(cand) > max_views:
        rng = np.random.default_rng(seed)
        cand = sorted(rng.permutation(np.asarray(cand))[:max_views]
                      .tolist())
    return cand
