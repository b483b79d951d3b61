"""Port parity for PatchMatch: one propagation pass on a given state
against the JAX pass (s-volume sampler), the prop_banks_fine = 0 pin, the
pyramid lift and downsample, and the schedules.

Propagation tolerance: the resulting costs agree to the B1 spec
(tests/test_torch_ncc.py), and the winning plane is the same wherever the
JAX winner beats the runner-up (stored cost included) by more than 1e-3 —
below that, cost noise of the spec's size may flip the pick."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.models import patchmatch as jpm
from tsar_mvs_tpu.ops import checkerboard as jcb
from tsar_mvs_tpu.ops import ncc as jncc
from tsar_mvs_tpu.ops import svolume as jsv
from tsar_mvs_tpu.utils.synthetic import make_scene
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import ncc

torch.set_num_threads(2)
H, W = 48, 64


def _state(rng, scene, jc):
    """A half-converged plane field: GT planes with depth noise on most
    pixels, random planes on the rest, random stored costs."""
    gt = np.where(np.isfinite(scene.depth[0]), scene.depth[0],
                  scene.depth_max)
    n = scene.normal_cam[0].copy()
    rand_n = rng.standard_normal((H, W, 3))
    rand_n /= np.linalg.norm(rand_n, axis=-1, keepdims=True)
    vv = np.asarray(jgeo.view_vectors(jc, H, W))
    rand_n = np.where(np.sum(rand_n * vv, -1, keepdims=True) > 0, -rand_n,
                      rand_n)
    wild = rng.random((H, W)) < 0.3
    n = np.where(wild[..., None], rand_n, n)
    depth = gt * (1.0 + 0.03 * rng.standard_normal((H, W)))
    depth = np.where(wild, rng.uniform(scene.depth_min * 1.05,
                                       scene.depth_max * 0.95, (H, W)),
                     depth)
    rays = np.asarray(jgeo.pixel_rays(jc, H, W))
    d = -depth * np.sum(n * rays, -1)
    return jpm.PlaneState(
        normal=jnp.asarray(n, jnp.float32), d=jnp.asarray(d, jnp.float32),
        cost=jnp.asarray(rng.uniform(0.2, 1.5, (H, W)), jnp.float32),
        ratio=jnp.asarray(rng.uniform(0, 1, (H, W)), jnp.float32),
        best_view=jnp.asarray(rng.integers(1, 3, (H, W)), jnp.int32))


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(height=H, width=W, num_views=3, seed=1)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    tc = convert.camera_set(jc, "cpu")
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images)
    view_ids = (1, 2)
    idx = jnp.asarray(view_ids, jnp.int32)
    s_lo, s_hi = jsv.s_range_for_depths(params.depth_min, params.depth_max,
                                        params.svolume_margin)
    counts = jpm.svolume_plane_counts(jc, view_ids, H, W, params)
    jvol = jsv.build_svolume(imgs[idx], jc.A[idx], jc.b[idx], s_lo, s_hi,
                             counts)
    jstats = jncc.precompute_ref_stats(imgs[0], jc, params)
    valid = jnp.ones((2,), bool)

    def eval_view_cost(normal, d, st, coords, parity=None):
        return jsv.multiview_cost_svolume(jvol, idx, valid, normal, d, st,
                                          params, parity=parity)

    j_cost_fn, j_pctx = jpm._make_cost_and_ctx(jstats, jc, H, W,
                                               eval_view_cost)
    tparams = convert.algorithm_params(params)
    tstats = ncc.precompute_ref_stats(torch.as_tensor(scene.images[0]), tc,
                                      tparams)
    t_cost_fn, t_pctx = pm.make_svolume_cost_fn(
        tstats, tc, H, W, convert.svolume(jvol, "cpu"),
        torch.tensor(view_ids), tparams)
    jstate = _state(np.random.default_rng(0), scene, jc)
    return dict(scene=scene, jc=jc, tc=tc, params=params, tparams=tparams,
                j=(j_cost_fn, j_pctx), t=(t_cost_fn, t_pctx),
                jstate=jstate, tstate=convert.plane_state(jstate, "cpu"))


def test_propagation_pass_matches_jax(setup):
    s = setup
    params = s["params"]
    parity = 0
    j_cost_fn, j_pctx = s["j"]
    t_cost_fn, t_pctx = s["t"]
    jout = jpm._propagation_pass(s["jstate"], parity, j_cost_fn, s["jc"],
                                 params, None, j_pctx)
    tout = pm._propagation_pass(s["tstate"], parity, t_cost_fn, s["tc"],
                                s["tparams"], t_pctx)

    # JAX's candidate costs, to find pixels with a clear winner.
    st = s["jstate"]
    cands = jcb.select_candidates(st.normal, st.d, st.cost)
    cn = jcb.parity_compress_vec(cands.normal, parity)
    cd = jcb.parity_compress(cands.d, parity)
    mv = j_cost_fn(cn, cd, parity)
    xx, yy = j_pctx.coords[parity]
    dep = jgeo.depth_from_plane(s["jc"], cn, cd, xx, yy)
    ok = (jcb.parity_compress(cands.valid, parity)
          & (dep >= s["jc"].depth_min) & (dep <= s["jc"].depth_max))
    cc = np.asarray(jnp.where(ok, mv.cost, jnp.inf))
    allc = np.concatenate([np.asarray(jcb.parity_compress(st.cost,
                                                          parity))[None],
                           cc])
    srt = np.sort(allc, axis=0)
    clear = (srt[1] - srt[0]) > 1e-3

    def packed(a):
        return np.asarray(jcb.parity_compress(jnp.asarray(a), parity))

    jc_cost, tc_cost = packed(jout.cost), packed(tout.cost.numpy())
    delta = np.abs(jc_cost - tc_cost)
    sharp = np.minimum(jc_cost, tc_cost) < 0.99
    assert np.quantile(delta[sharp], 0.5) < 5e-4
    assert np.quantile(delta[sharp], 0.99) < 5e-3
    np.testing.assert_array_equal(packed(tout.d.numpy())[clear],
                                  packed(jout.d)[clear])
    for k in range(3):
        np.testing.assert_array_equal(
            packed(tout.normal[..., k].numpy())[clear],
            packed(np.asarray(jout.normal)[..., k])[clear])
    # Ties (several candidates at cost_max) leave no clear winner.
    assert clear.mean() > 0.75
    # The other parity is untouched.
    other = cb.parity_mask(H, W, 1 - parity).numpy()
    np.testing.assert_array_equal(tout.d.numpy()[other],
                                  np.asarray(s["jstate"].d)[other])


def test_prop_banks_zero_selects_all_eight(setup):
    """prop_banks_fine = 0 reaches a lifted level as prop_banks = 0; the JAX
    package's `cands[-0:]` slice then keeps all 8 banks. The port does the
    same on purpose."""
    s = setup
    base = s["tparams"]
    assert pm.prop_bank_count(dataclasses.replace(base, prop_banks=0)) == 8
    assert pm.prop_bank_count(dataclasses.replace(base, prop_banks=4)) == 4
    assert pm.prop_bank_count(dataclasses.replace(base, prop_banks=8)) == 8
    t_cost_fn, t_pctx = s["t"]
    outs = [pm._propagation_pass(s["tstate"], 1, t_cost_fn, s["tc"],
                                 dataclasses.replace(base, prop_banks=k),
                                 t_pctx)
            for k in (0, 8)]
    np.testing.assert_array_equal(outs[0].d.numpy(), outs[1].d.numpy())


def test_pyramid_resampling_matches_jax(setup):
    s = setup
    scene = s["scene"]
    imgs = scene.images
    np.testing.assert_allclose(
        pm.downsample_2x(torch.as_tensor(imgs)).numpy(),
        np.asarray(jpm.downsample_2x(jnp.asarray(imgs))), atol=1e-5)
    coarse = s["jstate"]
    for (Hf, Wf) in ((2 * H, 2 * W), (2 * H + 1, 2 * W - 1)):
        jf = jgeo.build_camera_set(list(scene.P), cam_scale=0.5,
                                   depth_min=scene.depth_min,
                                   depth_max=scene.depth_max)
        tf = convert.camera_set(jf, "cpu")
        ju = jpm.upsample_state_2x(coarse, jf, Hf, Wf)
        tu = pm.upsample_state_2x(s["tstate"], tf, Hf, Wf)
        for field in pm.PlaneState._fields:
            np.testing.assert_allclose(getattr(tu, field).numpy(),
                                       np.asarray(getattr(ju, field)),
                                       atol=1e-5, rtol=1e-5, err_msg=field)


def test_schedules_match():
    for p in (AlgorithmParams(), AlgorithmParams(iterations=2),
              AlgorithmParams(iterations_fine=0),
              AlgorithmParams(refine_dz0_frac=0.05, max_disparity=40.0)):
        tp = convert.algorithm_params(p)
        assert pm.refine_schedule(tp) == jpm.refine_schedule(p)
        for levels in (1, 2, 3):
            assert pm.iteration_schedule(tp, levels) == \
                jpm.iteration_schedule(p, levels)


def test_run_patchmatch_improves_costs(setup):
    """Random init plus two iterations on the port's own sampler lowers the
    mean cost and keeps it in [0, cost_max]."""
    s = setup
    g = torch.Generator().manual_seed(0)
    imgs = torch.as_tensor(s["scene"].images)
    init = pm.run_patchmatch(g, imgs, (1, 2), s["tc"], s["tparams"],
                             iterations=0)
    out = pm.run_patchmatch(g, imgs, (1, 2), s["tc"], s["tparams"],
                            iterations=2, init_state=init)
    assert out.cost.mean() < init.cost.mean()
    assert (out.cost >= 0).all() and (out.cost <= 2.0).all()
    assert out.best_view.dtype == torch.int32
