"""Ground-truth evaluation harness (the port's copy of
``tsar_mvs_tpu.eval``; numpy and scipy only).

Equivalent of the reference's compiled-in GT metric code
(groundTruthUtils.h:22-139, computeError / computeNormalError) plus the
north-star point-cloud F-score protocol (BASELINE.json: ETH3D F1@2cm).

Per-pixel depth/disparity metrics follow the reference semantics:

* ``error``        — fraction of pixels whose |disp - gt| exceeds the
                     tolerance over *all* pixels with GT.
* ``error_nocc``   — same, restricted to non-occluded pixels (the
                     reference consumes a Middlebury occlusion mask via
                     ``-occl_mask``; occluded = mask value 128).
* ``error_valid``  — same, restricted to pixels where the estimate is
                     valid (cost < MAXCOST / depth > 0), i.e. precision
                     of the produced estimates.
* ``error_valid_all`` — |valid ∧ wrong| / |has GT| with invalid pixels
                     counted as wrong — the completeness-aware rate.

Normal evaluation returns the per-pixel angular error (degrees) and its
mean over valid pixels (computeNormalError contract).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DepthErrorResult:
    error: float            # wrong / with_gt
    error_nocc: float       # wrong ∧ nocc / with_gt ∧ nocc
    error_valid: float      # wrong ∧ valid / with_gt ∧ valid
    error_valid_all: float  # (wrong ∧ valid + invalid) / with_gt
    abs_err_mean: float     # mean |err| over valid ∧ with_gt
    abs_err_map: np.ndarray  # (H, W) |disp - gt| (NaN where no GT)
    num_gt: int
    num_valid: int


def depth_error(est: np.ndarray, gt: np.ndarray,
                tolerance: float = 1.0,
                valid: np.ndarray | None = None,
                occl_mask: np.ndarray | None = None,
                occluded_value: int = 128) -> DepthErrorResult:
    """Per-pixel error rates of an estimated disparity/depth map vs GT.

    ``est``/``gt``: (H, W) float; GT pixels with value <= 0 or non-finite
    carry no ground truth. ``valid``: bool map of produced estimates
    (defaults to est > 0). ``occl_mask``: uint8 Middlebury-style mask —
    pixels equal to ``occluded_value`` are occluded.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    has_gt = np.isfinite(gt) & (gt > 0)
    if valid is None:
        valid = np.isfinite(est) & (est > 0)
    valid = np.asarray(valid, bool)

    err = np.abs(est - gt)
    wrong = (err > tolerance) & has_gt

    n_gt = int(has_gt.sum())
    n_valid = int((valid & has_gt).sum())

    def rate(num, den):
        return float(num) / float(den) if den > 0 else 0.0

    error = rate(wrong.sum(), n_gt)
    error_valid = rate((wrong & valid).sum(), n_valid)
    error_valid_all = rate((wrong & valid).sum() + (has_gt & ~valid).sum(),
                           n_gt)
    if occl_mask is not None:
        nocc = np.asarray(occl_mask) != occluded_value
        error_nocc = rate((wrong & nocc).sum(), (has_gt & nocc).sum())
    else:
        error_nocc = error

    sel = valid & has_gt
    abs_err_mean = float(err[sel].mean()) if sel.any() else 0.0
    err_map = np.where(has_gt, err, np.nan).astype(np.float32)
    return DepthErrorResult(error=error, error_nocc=error_nocc,
                            error_valid=error_valid,
                            error_valid_all=error_valid_all,
                            abs_err_mean=abs_err_mean,
                            abs_err_map=err_map,
                            num_gt=n_gt, num_valid=n_valid)


@dataclass
class NormalErrorResult:
    angle_err_deg: np.ndarray  # (H, W), NaN where no GT
    mean_deg: float
    median_deg: float
    frac_within_10deg: float
    frac_within_30deg: float


def normal_error(est: np.ndarray, gt: np.ndarray,
                 valid: np.ndarray | None = None) -> NormalErrorResult:
    """Angular error between unit-normal maps (computeNormalError
    contract, groundTruthUtils.h:96-139). GT pixels whose normal is the
    zero vector carry no ground truth."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    gt_norm = np.linalg.norm(gt, axis=-1)
    est_norm = np.linalg.norm(est, axis=-1)
    has_gt = gt_norm > 1e-6
    if valid is None:
        valid = est_norm > 1e-6
    sel = has_gt & np.asarray(valid, bool)

    cosang = np.sum(est * gt, axis=-1) / np.maximum(est_norm * gt_norm,
                                                    1e-12)
    ang = np.degrees(np.arccos(np.clip(np.abs(cosang), -1.0, 1.0)))
    ang_map = np.where(sel, ang, np.nan).astype(np.float32)
    vals = ang[sel]
    if vals.size == 0:
        return NormalErrorResult(ang_map, 0.0, 0.0, 0.0, 0.0)
    return NormalErrorResult(
        angle_err_deg=ang_map,
        mean_deg=float(vals.mean()),
        median_deg=float(np.median(vals)),
        frac_within_10deg=float((vals < 10.0).mean()),
        frac_within_30deg=float((vals < 30.0).mean()))


@dataclass
class FScoreResult:
    precision: float
    recall: float
    f1: float
    threshold: float


def point_cloud_fscore(est_points: np.ndarray, gt_points: np.ndarray,
                       threshold: float = 0.02,
                       max_points: int = 200_000,
                       seed: int = 0) -> FScoreResult:
    """ETH3D-style F-score at a distance threshold (default 2 cm).

    precision = fraction of estimated points within ``threshold`` of a GT
    point; recall = fraction of GT points within ``threshold`` of an
    estimated point. Point sets are subsampled to ``max_points`` for the
    KD-tree queries (the benchmark protocol tolerates subsampling on the
    estimate side; we subsample both for bounded runtime).
    """
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)

    def sub(p):
        p = np.asarray(p, np.float64).reshape(-1, 3)
        p = p[np.isfinite(p).all(axis=1)]
        if p.shape[0] > max_points:
            p = p[rng.permutation(p.shape[0])[:max_points]]
        return p

    est = sub(est_points)
    gt = sub(gt_points)
    if est.shape[0] == 0 or gt.shape[0] == 0:
        return FScoreResult(0.0, 0.0, 0.0, threshold)

    d_est, _ = cKDTree(gt).query(est, k=1)
    d_gt, _ = cKDTree(est).query(gt, k=1)
    precision = float((d_est <= threshold).mean())
    recall = float((d_gt <= threshold).mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return FScoreResult(precision, recall, f1, threshold)
