"""Port parity for the TSAR refinement stages, given one PatchMatch-like
state (GT planes with noise, made with numpy) handed to both packages.

Tolerances:
* confidence, fill, fake depth and finalize: atol 1e-4 (float32 plane
  algebra; the confidence's reverse NCC sums in the same order). In the
  scene's textureless region the window variances sit at the min_var
  knife edge, where NCC amplifies last-bit differences of exp and rsqrt
  without bound (about 4% of its pixels differ by more than 1e-4), so
  the confidence is held to atol on textured pixels and on >= 98% of all
  pixels, as the cost kernel's spec does;
* WMF mark and fill reliability masks equal on >= 99.9% of pixels: ties
  in the exp weights and the order of the weight sums can flip a median;
* RANSAC inlier counts within 2% of JAX's per region: the two packages
  draw different random numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.models import patchmatch as jpm
from tsar_mvs_tpu.models import ransac as jransac
from tsar_mvs_tpu.models import tsar as jtsar
from tsar_mvs_tpu.models import weak_texture as wt
from tsar_mvs_tpu.ops import wmf as jwmf
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch.models import ransac
from tsar_mvs_tpu_torch.models import tsar
from tsar_mvs_tpu_torch.ops import wmf

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(scene):
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    tc = convert.camera_set(jc, "cpu")
    params = AlgorithmParams(
        weak_text_num=25, hough_thr=12, min_line_length=12, max_line_gap=3,
        ransac_iters=2000, ransac_anneal_rounds=200, ransac_thr_base=0.005,
        ransac_thr_max=0.05, ransac_thr_step=0.002, wmf_drift_thr=2.0,
    ).with_depth_range(scene.depth_min, scene.depth_max, float(jc.f))
    H, W = scene.images.shape[1:]
    rng = np.random.default_rng(0)
    gt = np.where(np.isfinite(scene.depth[0]), scene.depth[0],
                  scene.depth_max)
    depth = gt * (1.0 + 0.01 * rng.standard_normal((H, W)))
    bad = rng.random((H, W)) < 0.1
    depth = np.where(bad, gt * rng.uniform(0.7, 1.3, (H, W)), depth)
    n = scene.normal_cam[0]
    rays = np.asarray(jgeo.pixel_rays(jc, H, W))
    d = -depth * np.sum(n * rays, -1)
    jstate = jpm.PlaneState(
        normal=jnp.asarray(n, jnp.float32), d=jnp.asarray(d, jnp.float32),
        cost=jnp.asarray(rng.uniform(0.05, 0.6, (H, W)), jnp.float32),
        ratio=jnp.asarray(rng.uniform(0.3, 1, (H, W)), jnp.float32),
        best_view=jnp.asarray(rng.integers(1, 5, (H, W)), jnp.int32))
    weak = wt.detect_weak_texture(scene.images[0], params, pyr_levels=1)
    return dict(scene=scene, jc=jc, tc=tc, params=params,
                tparams=convert.algorithm_params(params), jstate=jstate,
                tstate=convert.plane_state(jstate, "cpu"), weak=weak, H=H,
                W=W)


def test_confidence_matches(setup):
    s = setup
    imgs = s["scene"].images
    jconf, jlr, jdisp = jtsar.confidence_stage(
        jnp.asarray(imgs), (1, 2, 3, 4), s["jc"], s["jstate"], s["params"])
    tconf, tlr, tdisp = tsar.confidence_stage(
        torch.as_tensor(imgs), (1, 2, 3, 4), s["tc"], s["tstate"],
        s["tparams"])
    textured = ~s["scene"].weak_mask[0]
    for t, j in ((tconf, jconf), (tlr, jlr)):
        delta = np.abs(t.numpy() - np.asarray(j))
        assert delta[textured].max() <= 1e-4, delta[textured].max()
        assert (delta <= 1e-4).mean() >= 0.98
    np.testing.assert_allclose(tdisp.numpy(), np.asarray(jdisp), rtol=1e-5,
                               atol=1e-4)


def _disp(s):
    return np.asarray(jtsar.confidence_stage(
        jnp.asarray(s["scene"].images), (1, 2, 3, 4), s["jc"], s["jstate"],
        s["params"])[2])


def test_wmf_mark_masks_match(setup):
    s = setup
    disp = _disp(s)
    gray = s["scene"].images[0]
    rel = np.ones((s["H"], s["W"]), bool)
    rays = jgeo.pixel_rays(s["jc"], s["H"], s["W"])
    for it in range(4):
        chunk = 32 if it == 1 else 256   # it == 1 runs row-chunked
        jr = np.asarray(jwmf.wmf_mark_outliers(
            jnp.asarray(gray), s["jstate"].normal, s["jstate"].d,
            jnp.asarray(disp), jnp.asarray(rel), it, s["jc"], rays,
            s["params"], chunk_rows=chunk))
        tr = wmf.wmf_mark_outliers(
            torch.as_tensor(gray), s["tstate"].normal, s["tstate"].d,
            torch.as_tensor(disp), torch.as_tensor(rel), it, s["tc"],
            s["tparams"], chunk_rows=chunk).numpy()
        assert (tr == jr).mean() >= 0.999, (it, (tr == jr).mean())
        assert 0.02 < (~jr).mean() < 0.9
        rel = jr


def test_wmf_fill_matches(setup):
    s = setup
    disp = _disp(s)
    gray = s["scene"].images[0]
    rng = np.random.default_rng(1)
    rel = rng.random((s["H"], s["W"])) > 0.3
    textured = (s["weak"].text == 1)[s["weak"].labels_full]
    rays = jgeo.pixel_rays(s["jc"], s["H"], s["W"])
    normal, d = s["jstate"].normal, s["jstate"].d
    for it in range(3):
        jn, jd, jdisp, jr = jwmf.wmf_fill(
            jnp.asarray(gray), normal, d, jnp.asarray(disp),
            jnp.asarray(rel), jnp.asarray(textured), it, s["jc"], rays,
            s["params"])
        tn, td, tdisp, tr = wmf.wmf_fill(
            torch.as_tensor(gray), convert.tensor(normal, "cpu"),
            convert.tensor(d, "cpu"), torch.as_tensor(disp),
            torch.as_tensor(rel), torch.as_tensor(textured), it, s["tc"],
            s["tparams"])
        jr = np.asarray(jr)
        assert (tr.numpy() == jr).mean() >= 0.999
        same = tr.numpy() == jr
        np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                                   rtol=1e-4, atol=1e-4)
        normal, d, disp, rel = jn, jd, np.asarray(jdisp), jr
    assert rel.mean() > 0.75


def test_weighted_median_keys_roundtrip():
    x = torch.tensor([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, np.inf])
    k = wmf.float_to_ordered_key(x)
    assert (k[1:] >= k[:-1]).all() and k[2] == k[3]
    np.testing.assert_array_equal(wmf.ordered_key_to_float(k).numpy(),
                                  np.where(x.numpy() == 0, 0.0, x.numpy()))
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(jwmf._float_to_ordered_uint(
            jnp.asarray(x.numpy()))).astype(np.int64))


def test_ransac_inliers_within_two_percent(setup):
    s = setup
    weak, params = s["weak"], s["params"]
    gt = s["scene"].depth[0]
    rays = np.asarray(jgeo.pixel_rays(s["jc"], s["H"], s["W"]))
    rng = np.random.default_rng(2)
    regions = [r for r in np.nonzero(weak.text == -1)[0]
               if ((weak.labels_full == r) & np.isfinite(gt)).sum() > 50]
    assert regions
    for r in regions:
        m = (weak.labels_full == r) & np.isfinite(gt)
        pts = (gt[m] * (1 + 0.002 * rng.standard_normal(m.sum())))[:, None] \
            * rays[m]
        pts = pts.astype(np.float32)
        thr0 = float(jransac.initial_threshold(int(weak.size[r]),
                                               params.ransac_thr_base))
        assert ransac.initial_threshold(int(weak.size[r]),
                                        params.ransac_thr_base) == thr0
        kw = dict(iters=params.ransac_iters,
                  anneal_rounds=params.ransac_anneal_rounds,
                  thr_max=params.ransac_thr_max,
                  thr_step=params.ransac_thr_step)
        jfit = jransac.ransac_plane(jax.random.PRNGKey(int(r)),
                                    jnp.asarray(pts),
                                    jnp.ones(len(pts), bool), thr0, **kw)
        tfit = ransac.ransac_plane(torch.Generator().manual_seed(int(r)),
                                   torch.as_tensor(pts), thr0, **kw)
        ji, ti = int(jfit.inliers), int(tfit.inliers)
        assert abs(ti - ji) <= 0.02 * ji, (r, ti, ji)
        assert float(tfit.threshold) == pytest.approx(float(jfit.threshold),
                                                      rel=1e-5)


def test_fill_fake_depth_finalize_border_match(setup):
    s = setup
    weak, params = s["weak"], s["params"]
    gt = np.where(np.isfinite(s["scene"].depth[0]), s["scene"].depth[0],
                  s["scene"].depth_max)
    rays = np.asarray(jgeo.pixel_rays(s["jc"], s["H"], s["W"]))
    planes = np.zeros((weak.num_regions, 4), np.float32)
    for r in np.nonzero(weak.text == -1)[0]:
        m = weak.labels_full == r
        pts = gt[m][:, None] * rays[m]
        cen = pts.mean(0)
        nrm = np.linalg.svd(pts - cen, full_matrices=False)[2][2]
        planes[r] = np.append(nrm, -nrm @ cen)
    labels = weak.labels_full
    weak_region = weak.text == -1
    rel = np.random.default_rng(3).random((s["H"], s["W"])) > 0.2
    disp = _disp(s)

    jfake = np.asarray(jtsar.fake_depth_stage(
        s["jc"], jnp.asarray(planes), jnp.asarray(labels),
        jnp.asarray(weak_region), params))
    tfake = tsar.fake_depth_stage(
        s["tc"], torch.as_tensor(planes), torch.as_tensor(labels).long(),
        torch.as_tensor(weak_region), s["tparams"]).numpy()
    np.testing.assert_allclose(tfake, jfake, atol=1e-4)
    np.testing.assert_allclose(
        tsar.border_consistency_check(weak, tfake, disp, s["tc"]),
        jtsar.border_consistency_check(weak, jfake, disp, s["jc"]),
        rtol=1e-5, atol=1e-6)

    jst, jrel, jdisp = jtsar.fill_stage(
        s["jc"], s["jstate"], jnp.asarray(planes), jnp.asarray(labels),
        jnp.asarray(weak_region), jnp.asarray(rel), params)
    tst, trel, tdisp = tsar.fill_stage(
        s["tc"], s["tstate"], torch.as_tensor(planes),
        torch.as_tensor(labels).long(), torch.as_tensor(weak_region),
        torch.as_tensor(rel), s["tparams"])
    np.testing.assert_array_equal(trel.numpy(), np.asarray(jrel))
    for field in ("normal", "d", "cost"):
        np.testing.assert_allclose(getattr(tst, field).numpy(),
                                   np.asarray(getattr(jst, field)),
                                   atol=1e-4)
    np.testing.assert_allclose(tdisp.numpy(), np.asarray(jdisp), rtol=1e-5,
                               atol=1e-4)

    jdep, jnw = jtsar.finalize_stage(s["jc"], jst)
    tdep, tnw = tsar.finalize_stage(s["tc"], tst)
    np.testing.assert_allclose(tdep.numpy(), np.asarray(jdep), atol=1e-4)
    np.testing.assert_allclose(tnw.numpy(), np.asarray(jnw), atol=1e-4)


def test_prior_drift_revert_matches(setup):
    """prior_drift_revert on the noisy state against GT prior planes: the
    same pixels revert (>= 99.9%; a disparity drift at the threshold can
    flip) and the planes agree to atol 1e-5 where both decide alike."""
    s = setup
    gt = np.where(np.isfinite(s["scene"].depth[0]), s["scene"].depth[0],
                  s["scene"].depth_max)
    n = s["scene"].normal_cam[0].astype(np.float32)
    rays = np.asarray(jgeo.pixel_rays(s["jc"], s["H"], s["W"]))
    d = (-gt * np.sum(n * rays, -1)).astype(np.float32)
    jout = jtsar.prior_drift_revert(s["jc"], s["jstate"], jnp.asarray(n),
                                    jnp.asarray(d), drift_thr=6.0)
    tout = tsar.prior_drift_revert(s["tc"], s["tstate"], torch.as_tensor(n),
                                   torch.as_tensor(d), drift_thr=6.0)
    jrev = np.asarray(jout.d) != np.asarray(s["jstate"].d)
    trev = tout.d.numpy() != s["tstate"].d.numpy()
    assert 0.02 < trev.mean() < 0.2, trev.mean()
    assert (trev == jrev).mean() >= 0.999
    same = trev == jrev
    np.testing.assert_allclose(tout.d.numpy()[same], np.asarray(jout.d)[same],
                               atol=1e-5)
    np.testing.assert_allclose(tout.normal.numpy()[same],
                               np.asarray(jout.normal)[same], atol=1e-5)
