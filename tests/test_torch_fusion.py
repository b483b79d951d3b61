"""Port parity for fusion: tsar_mvs_tpu_torch.models.fusion and
pipeline.fuse_scene against the JAX package on conftest's 96x128x5 scene.

Tolerances:
* project: atol 1e-4 px and 1e-4 in projective depth (same float32
  arithmetic order);
* fusion_votes against JAX fusion_votes_traced, every reference view:
  emit, count and consumed equal on >= 99.95% of pixels (a vote sits on
  float32 threshold comparisons, which last-bit differences can flip);
  point and normal sums within atol 1e-4 on >= 99.95% of the pixels
  where both emit (the same flips, and coordinates that round to the
  neighbouring source pixel);
* fuse: point counts within 0.1%, per-view counts (the view_of
  histogram) within 0.1% of each view's count;
* the fused scene's F1@2cm against the GT cloud within 0.005 of JAX's
  fuse_scene on the same per-view depth maps.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import eval as ev
from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.config import AlgorithmParams, FusionParams
from tsar_mvs_tpu.models import fusion as jfusion
from tsar_mvs_tpu.utils import ply
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.models import fusion

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(scene):
    jc = jgeo.build_camera_set(list(scene.P), rebase=False)
    depths = np.where(np.isfinite(scene.depth), scene.depth,
                      0.0).astype(np.float32)
    normals = scene.normal_world.astype(np.float32)
    return dict(jc=jc, tc=convert.camera_set(jc, "cpu"), depths=depths,
                normals=normals)


def _holes(depths, seed=0):
    """A copy with 10% of every view's pixels zeroed (invalid)."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(depths.shape) < 0.1, 0.0,
                    depths).astype(np.float32)


def test_project_matches_jax(data):
    d = data["depths"]
    H, W = d.shape[1:]
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    X = np.asarray(jgeo.backproject(data["jc"], 0, jnp.asarray(xx),
                                    jnp.asarray(yy), jnp.asarray(d[0])))
    for v in range(d.shape[0]):
        jq, jw = jgeo.project(data["jc"], v, jnp.asarray(X))
        tq, tw = geo.project(data["tc"], v, torch.as_tensor(X))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("ref", range(5))
@pytest.mark.parametrize("case", ["gt", "holes_half_used"])
def test_fusion_votes_match_jax(data, case, ref):
    depths, normals = data["depths"], data["normals"]
    used = np.zeros(depths.shape, bool)
    if case == "holes_half_used":
        depths = _holes(depths)
        used[:, :, : depths.shape[2] // 2] = True
    fp = FusionParams()
    j = jfusion._fusion_votes_traced_jit(
        jnp.asarray(ref, jnp.int32), jnp.asarray(depths),
        jnp.asarray(normals), data["jc"], jnp.asarray(used), fp)
    t = fusion.fusion_votes(ref, torch.as_tensor(depths),
                            torch.as_tensor(normals), data["tc"],
                            torch.as_tensor(used),
                            convert.fusion_params(fp))
    j = [np.asarray(a) for a in j]
    t = [a.numpy() for a in t]
    for name, k in (("count", 2), ("emit", 3), ("consumed", 4)):
        agree = (t[k] == j[k]).mean()
        assert agree >= 0.9995, (name, agree)
    # A flipped vote, or a projection that rounds to the neighbouring
    # source pixel (a coordinate at x.5 within float32 rounding), changes
    # that pixel's sums; they are held on the same share of pixels.
    both = t[3] & j[3]
    assert both.sum() > 0.2 * both.size
    for k in (0, 1):
        close = (np.abs(t[k] - j[k]) <= 1e-4).all(axis=-1)[both]
        assert close.mean() >= 0.9995, close.mean()


@pytest.mark.parametrize("used_list", [True, False])
def test_fuse_matches_jax(scene, data, used_list):
    fp = FusionParams(used_list=used_list)
    j = jfusion.fuse(data["depths"], data["normals"], data["jc"],
                     scene.images, fp)
    t = fusion.fuse(data["depths"], data["normals"], data["tc"],
                    scene.images, convert.fusion_params(fp))
    nj, nt = j.points.shape[0], t.points.shape[0]
    assert abs(nt - nj) <= 0.001 * nj, (nt, nj)
    hj = np.bincount(j.view_of, minlength=5)
    ht = np.bincount(t.view_of, minlength=5)
    assert (np.abs(ht - hj) <= 0.001 * hj).all(), (ht, hj)
    assert t.points.dtype == np.float32 and t.colors.dtype == np.uint8
    assert np.isfinite(t.points).all()
    np.testing.assert_allclose(np.linalg.norm(t.normals, axis=-1), 1.0,
                               atol=1e-5)


def test_used_list_deduplicates(scene, data):
    counts = [fusion.fuse(data["depths"], data["normals"], data["tc"],
                          scene.images,
                          convert.fusion_params(FusionParams(used_list=u))
                          ).points.shape[0] for u in (True, False)]
    assert counts[0] < counts[1]


def test_nonfinite_coordinates_stay_out_of_bounds(data):
    """NaN and +-inf coordinates are out of bounds. The mask comes from
    the float coordinates: cast to an integer, NaN is 0 on CUDA (and on
    the JAX CPU backend), which would read pixel (0, 0)."""
    img = torch.arange(12.0).reshape(3, 4)
    nan, inf = float("nan"), float("inf")
    qx = torch.tensor([nan, inf, -inf, 1.0, 0.0, 3.4, 3.6, -0.6, 2.5])
    qy = torch.tensor([0.0, 0.0, 0.0, nan, inf, 2.0, 2.0, 0.0, 1.5])
    vals, inb, flat = fusion._nearest_lookup(img, qx, qy)
    assert inb.tolist() == [False] * 5 + [True, False, False, True]
    # In bounds: rounding half to even, as jnp.round (2.5 -> 2, 1.5 -> 2).
    assert vals[inb].tolist() == [11.0, 10.0]
    assert ((flat >= 0) & (flat < 12)).all()
    # A reference view whose depths are inf projects to non-finite
    # coordinates everywhere: nothing votes, nothing is consumed.
    depths = torch.as_tensor(data["depths"]).clone()
    depths[0] = float("inf")
    _, _, count, emit, consumed = fusion.fusion_votes(
        0, depths, torch.as_tensor(data["normals"]), data["tc"],
        torch.zeros(depths.shape, dtype=torch.bool),
        convert.fusion_params(FusionParams()))
    assert int(count.sum()) == 0 and not emit.any() and not consumed.any()


def test_inconsistent_depths_rejected(scene, data):
    """Corrupting every source view's depths suppresses the points of view
    0 that need two consistent views (tests/test_fusion.py's case)."""
    fp = convert.fusion_params(FusionParams(used_list=False,
                                            num_consistent=2))
    base = fusion.fuse(data["depths"], data["normals"], data["tc"],
                       scene.images, fp)
    bad = data["depths"].copy()
    bad[1:] *= 1.3
    corrupted = fusion.fuse(bad, data["normals"], data["tc"], scene.images,
                            fp)
    n_base = (base.view_of == 0).sum()
    assert n_base > 0.5 * bad[0].size
    assert (corrupted.view_of == 0).sum() < 0.1 * n_base


def _gt_cloud(scene):
    spec = importlib.util.spec_from_file_location(
        "validate_synthetic", REPO / "scripts" / "validate_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gt_cloud(scene, stride=1)


def test_fuse_scene_matches_jax(scene, tmp_path):
    """The port's process_scene (3 iterations, tests/test_tsar.py's
    small-scene refinement parameters) and fuse_scene, then the JAX
    fuse_scene on the same results/ depth maps: F1@2cm against the GT
    cloud within 0.005. At 96x128 the port's F1 measured 0.80; the floor
    0.75 catches a broken scene loop or fusion."""
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu_torch import pipeline as tpipe
    root = scene.export(tmp_path / "scene")
    params = AlgorithmParams(
        iterations=3, weak_text_num=25, hough_thr=12, min_line_length=12,
        max_line_gap=3, ransac_iters=2000, ransac_anneal_rounds=200,
        ransac_thr_base=0.005, ransac_thr_max=0.05, ransac_thr_step=0.002,
        wmf_drift_thr=2.0, wmf_iters=2, wmf_final_iters=3)
    results = tpipe.process_scene(root, convert.algorithm_params(params),
                                  write_ply=False, device="cpu")
    assert len(results) == scene.num_views
    gt = _gt_cloud(scene)

    def f1(path):
        pts = ply.read_ply(path)[0]
        pts = pts[np.isfinite(pts).all(1) & (np.abs(pts) > 1e-9).any(1)]
        return ev.point_cloud_fscore(pts, gt, threshold=0.02).f1

    out = tpipe.fuse_scene(root, device="cpu")
    assert out == root / "results" / "TSAR_fused.ply"
    f_torch = f1(out)
    f_jax = f1(jpipe.fuse_scene(root))
    assert abs(f_torch - f_jax) <= 0.005, (f_torch, f_jax)
    assert f_torch > 0.75, f_torch
