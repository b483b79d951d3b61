"""Port parity for the direct sampler: the grayscale and colour costs
(`ncc.pm_cost_ab`, `ncc_color.pm_cost_ab_color`) and their multi-view
aggregation for n_best 1, 2 and 3 against the JAX functions on the same
bf16-packed sources and plane fields (numpy seeds), the best-n
aggregation exactly on toy costs, the odd-sided pyramid level (C8) on
both samplers, PatchMatch accuracy on the direct and colour paths, the
sampler rule and the CLI's colour and n_best runs. Kernel B3 against its
plain version needs a card (`cuda` marker).

Cost tolerance: tests/test_torch_ncc.py::assert_cost_agreement (the spec
of tests/test_pallas_ncc.py:44-46). Both sides sample the same bf16
corners in float32 and sum in the same order; XLA may contract a
multiply and an add where PyTorch rounds twice, and NCC divides by
sqrt(var_src), which amplifies that last-bit noise as var_src -> 0.
Observed at 48x64 on the CPU (4 candidates against view 2, dense grid
and both parities): q99 |delta| 1.5e-6 in grayscale and 1.1e-6 in
colour; max 4.1e-6 in colour, and in grayscale 1.0 on 0.04-0.08% of the
pixels, where a window variance sits at the min_var knife edge (ROADMAP
C3) and one side returns cost_max.

A non-finite plane (d = 0, the border banks' padding) costs cost_max with
view -1 in the port, in the kernel as in its plain version; JAX's direct
path returns NaN there (a NaN coordinate poisons its lerp). Accept
decisions are the same either way (`NaN < c` and `2.0 < 2.0` are both
false), so the comparisons with JAX use finite planes and the port's
mapping is pinned on its own."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ncc import assert_cost_agreement

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.models import patchmatch as jpm
from tsar_mvs_tpu.ops import checkerboard as jcb
from tsar_mvs_tpu.ops import ncc as jncc
from tsar_mvs_tpu.ops import ncc_color as jnc
from tsar_mvs_tpu.ops import sampling as jsampling
from tsar_mvs_tpu.ops import svolume as jsv
from tsar_mvs_tpu.utils.synthetic import make_scene
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch.kernel_times import color_from_gray
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import cuda_direct, ncc
from tsar_mvs_tpu_torch.ops import ncc_color as nc
from tsar_mvs_tpu_torch.ops.sampling import pack_image
from tsar_mvs_tpu_torch import trace

torch.set_num_threads(2)
H, W = 48, 64
TOL = 5e-3  # the q99 bound of assert_cost_agreement


def _planes(rng, cams_j, rays, scene, shape):
    """Random planes: normals on the camera-facing hemisphere, depths
    inside the scene's range."""
    n = rng.standard_normal(shape + (3,))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vv = np.asarray(jgeo.view_vectors(cams_j, *shape[-2:]))
    n = np.where(np.sum(n * vv, -1, keepdims=True) > 0, -n, n)
    depth = rng.uniform(scene.depth_min * 1.05, scene.depth_max * 0.95,
                        shape)
    d = -depth * np.sum(n * np.asarray(rays), -1)
    return n.astype(np.float32), d.astype(np.float32)


def _jit_stats(fn):
    """A JAX statistics precomputation, compiled once (eager, its 36
    shifts compile one by one and take seconds each)."""
    return jax.jit(fn, static_argnames=("params",))


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(height=H, width=W, num_views=5, seed=3)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images, jnp.float32)
    rgb = color_from_gray(scene.images)
    tc = convert.camera_set(jc, "cpu")
    tparams = convert.algorithm_params(params)
    jstats = _jit_stats(jncc.precompute_ref_stats)(imgs[0], jc, params)
    n, d = _planes(np.random.default_rng(4), jc, jstats.rays, scene,
                   (4, H, W))
    return dict(
        scene=scene, jc=jc, tc=tc, params=params, tparams=tparams,
        rgb=rgb, jstats=jstats,
        tstats=ncc.precompute_ref_stats(torch.as_tensor(scene.images[0]),
                                        tc, tparams),
        jcstats=_jit_stats(jnc.precompute_ref_stats_color)(
            jnp.asarray(rgb[0]), jc, params),
        tcstats=nc.precompute_ref_stats_color(torch.as_tensor(rgb[0]), tc,
                                              tparams),
        jpacked={v: jsampling.pack_image(imgs[v], jnp.bfloat16)
                 for v in range(1, 5)},
        tpacked={v: pack_image(torch.as_tensor(scene.images[v]),
                               torch.bfloat16) for v in range(1, 5)},
        jcpacked={v: jnc.pack_image_color(jnp.asarray(rgb[v]))
                  for v in range(1, 5)},
        tcpacked={v: nc.pack_image_color(torch.as_tensor(rgb[v]))
                  for v in range(1, 5)},
        n=n, d=d)


def _restrict(s, parity, C, color=False):
    """(jax stats, port stats, n, d, jax coords, port coords) of the first
    C candidates on the dense grid (parity None) or one packed class."""
    jst = s["jcstats" if color else "jstats"]
    tst = s["tcstats" if color else "tstats"]
    n, d = s["n"][:C], s["d"][:C]
    if parity is None:
        return jst, tst, n, d, None, None
    jcomp = jnc.compress_stats_color if color else jncc.compress_stats
    tcomp = nc.compress_stats_color if color else ncc.compress_stats
    n = np.array(jcb.parity_compress_vec(jnp.asarray(n), parity))
    d = np.array(jcb.parity_compress(jnp.asarray(d), parity))
    return (jcomp(jst, parity), tcomp(tst, parity), n, d,
            jcb.parity_coords(H, W, parity),
            cb.parity_coords(H, W, parity, "cpu"))


@pytest.mark.parametrize("parity,color", [(None, False), (0, False),
                                          (1, False), (None, True),
                                          (0, True)])
def test_pm_cost_ab_matches_jax(setup, parity, color):
    """The port's direct cost against JAX's ncc.pm_cost_ab (grayscale) and
    ncc_color.pm_cost_ab_color (three unequal channels) on one bf16 packed
    source view, 4 candidates per pixel (q99 |delta| 1.5e-6)."""
    s = setup
    jst, tst, n, d, jco, tco = _restrict(s, parity, 4, color)
    jfn, tfn = ((jnc.pm_cost_ab_color, nc.pm_cost_ab_color) if color
                else (jncc.pm_cost_ab, ncc.pm_cost_ab))
    jpk, tpk = ((s["jcpacked"], s["tcpacked"]) if color
                else (s["jpacked"], s["tpacked"]))
    cj = jax.jit(lambda n_, d_: jfn(
        jpk[2], s["jc"].A[2], s["jc"].b[2], n_, d_, jst, s["params"],
        coords=jco))(jnp.asarray(n), jnp.asarray(d))
    ct = tfn(tpk[2], s["tc"].A[2], s["tc"].b[2], torch.as_tensor(n),
             torch.as_tensor(d), tst, s["tparams"], tco).numpy()
    cj = np.asarray(cj)
    assert ct.shape == cj.shape
    assert_cost_agreement(ct, cj)


def _clear_winner(mj, mt, per_view):
    """Pixels whose winning view is clear on both sides: the two smallest
    per-view costs (the port's, which match JAX's to the spec above) lead
    by more than 2 * TOL, and each side's ratio says the same."""
    srt = np.sort(per_view, axis=0)
    lead_t = (srt[1] - srt[0]) if len(srt) > 1 else np.zeros_like(srt[0])
    best = srt[0]
    lead = {}
    for k, mv in (("j", mj), ("t", mt)):
        r = np.asarray(mv.ratio)
        lead[k] = np.where(r > 0, best / np.maximum(r, 1e-12) - best, 0.0)
    return ((np.minimum(np.minimum(lead["j"], lead["t"]), lead_t)
             > 2 * TOL) & (best < jncc.MAXCOST - TOL))


@pytest.mark.parametrize("n_best,V,C,parity,color", [
    (1, 3, 4, 0, False), (2, 4, 1, None, False), (3, 4, 4, 1, False),
    (2, 1, 1, 0, False), (3, 3, 1, None, False), (1, 1, 4, None, False),
    (1, 4, 1, 1, True), (3, 4, 4, 0, True)])
def test_multiview_cost_matches_jax(setup, n_best, V, C, parity, color):
    """multiview_cost (grayscale) and multiview_cost_color against JAX's
    for n_best 1-3, V 1-4, C 1 and 4: the cost to the spec above; the
    best view equal and the ratio within 2e-2 (q99) where the winner is
    clear (up to 0.5% of those pixels may flip on a per-view outlier that
    the spec allows)."""
    s = setup
    params = dataclasses.replace(s["params"], n_best=n_best)
    tparams = dataclasses.replace(s["tparams"], n_best=n_best)
    jst, tst, n, d, jco, tco = _restrict(s, parity, C, color)
    view_ids = tuple(range(1, V + 1))
    if color:
        jfn, tfn = jnc.multiview_cost_color, nc.multiview_cost_color
        jpk, tpk = s["jcpacked"], s["tcpacked"]
    else:
        jfn, tfn = jncc.multiview_cost, ncc.multiview_cost
        jpk, tpk = s["jpacked"], s["tpacked"]
    mj = jax.jit(lambda n_, d_: jfn(jpk, view_ids, s["jc"], n_, d_, jst,
                                    params, coords=jco))(
        jnp.asarray(n), jnp.asarray(d))
    nt, dt = torch.as_tensor(n), torch.as_tensor(d)
    mt = tfn(tpk, view_ids, s["tc"], nt, dt, tst, tparams, tco)
    cj, ct = np.asarray(mj.cost), mt.cost.numpy()
    assert ct.shape == cj.shape and mt.best_view.dtype == torch.int32
    assert_cost_agreement(ct, cj)
    cost_one = nc.pm_cost_ab_color if color else ncc.pm_cost_ab
    per_view = np.stack([cost_one(tpk[v], s["tc"].A[v], s["tc"].b[v], nt,
                                  dt, tst, tparams, tco).numpy()
                         for v in view_ids])
    if V == 1:
        clear = per_view[0] < jncc.MAXCOST - TOL
    else:
        clear = _clear_winner(mj, mt, per_view)
    assert clear.mean() > 0.3
    same = (mt.best_view.numpy() == np.asarray(mj.best_view))[clear]
    assert same.mean() > 0.995, float(same.mean())
    sharp = clear & (np.minimum(ct, cj) < 0.99)
    rj, rt = np.asarray(mj.ratio), mt.ratio.numpy()
    assert np.quantile(np.abs(rt - rj)[sharp], 0.99) < 2e-2


@pytest.mark.parametrize("n_best", [1, 2, 3])
def test_aggregate_view_costs_matches_jax(n_best):
    """Best-n aggregation on toy costs, exactly: ties (the first argmin
    wins), a pixel with no valid view (cost MAXCOST, ratio 0, view -1), a
    pixel with one valid view, and V = 1."""
    costs = np.array([[0.5, 2.0, 0.7, 0.25, 2.0],
                      [0.5, 2.0, 0.25, 0.25, 0.75],
                      [0.75, 2.0, 0.25, 0.125, 2.0],
                      [1.0, 2.0, 1.5, 0.5, 2.0]], np.float32)
    ids = [5, 2, 9, 4]
    for V in (1, 2, 4):
        jp = AlgorithmParams(n_best=n_best)
        mj = jncc.aggregate_view_costs(jnp.asarray(costs[:V]),
                                       jnp.asarray(ids[:V]), jp)
        mt = ncc.aggregate_view_costs(torch.as_tensor(costs[:V]),
                                      torch.tensor(ids[:V]),
                                      convert.algorithm_params(jp))
        for field in ("cost", "ratio", "best_view"):
            np.testing.assert_array_equal(getattr(mt, field).numpy(),
                                          np.asarray(getattr(mj, field)),
                                          err_msg=f"{field} V={V}")
        assert mt.best_view.dtype == torch.int32


def test_color_equal_channels_match_grayscale(setup):
    """With three equal channels the colour cost is the grayscale cost at
    sigma_color / sqrt(3) (tests/test_ncc_color.py:33-57), to 2e-3."""
    s = setup
    img = torch.as_tensor(s["scene"].images)
    rgb = img[:, None].repeat(1, 3, 1, 1)
    n, d = torch.as_tensor(s["n"][0]), torch.as_tensor(s["d"][0])
    stats_c = nc.precompute_ref_stats_color(rgb[0], s["tc"], s["tparams"])
    cost_c = nc.pm_cost_ab_color(nc.pack_image_color(rgb[1]), s["tc"].A[1],
                                 s["tc"].b[1], n, d, stats_c, s["tparams"])
    params_g = dataclasses.replace(
        s["tparams"], sigma_color=s["tparams"].sigma_color / math.sqrt(3.0))
    stats_g = ncc.precompute_ref_stats(img[0], s["tc"], params_g)
    cost_g = ncc.pm_cost_ab(pack_image(img[1], torch.bfloat16),
                            s["tc"].A[1], s["tc"].b[1], n, d, stats_g,
                            params_g)
    np.testing.assert_allclose(cost_c.numpy(), cost_g.numpy(), atol=2e-3)


@pytest.mark.parametrize("color", [False, True])
def test_nonfinite_planes_cost_max_and_view_minus_one(setup, color):
    """d = 0 (and NaN normals) through the direct multi-view cost: cost
    cost_max against every view, so view -1 and ratio 0 (cost MAXCOST for
    n_best > 1); finite candidates beside them equal their solo
    evaluation."""
    s = setup
    parity = 1
    tst = (nc.compress_stats_color(s["tcstats"], parity) if color
           else ncc.compress_stats(s["tstats"], parity))
    n = cb.parity_compress_vec(torch.as_tensor(s["n"][:3]), parity).clone()
    d = cb.parity_compress(torch.as_tensor(s["d"][:3]), parity).clone()
    d[1] = 0.0
    n[2, ::2] = float("nan")
    pk = s["tcpacked"] if color else s["tpacked"]
    fn = nc.multiview_cost_color if color else ncc.multiview_cost
    coords = cb.parity_coords(H, W, parity, "cpu")
    for n_best in (1, 3):
        p = dataclasses.replace(s["tparams"], n_best=n_best)
        mv = fn(pk, (1, 2, 3), s["tc"], n, d, tst, p, coords)
        solo = fn(pk, (1, 2, 3), s["tc"], n[:1], d[:1], tst, p, coords)
        assert torch.equal(mv.cost[0], solo.cost[0])
        assert torch.equal(mv.best_view[0], solo.best_view[0])
        for bad in (mv.cost[1], mv.cost[2, ::2]):
            assert (bad == p.cost_max).all()
        assert (mv.best_view[1] == -1).all() and (mv.ratio[1] == 0).all()
        assert (mv.best_view[2, ::2] == -1).all()
        assert torch.isfinite(mv.ratio).all()


def test_resolve_ncc_impl():
    """An explicit sampler wins; "auto" is the s-volume for n_best 1 and
    the direct sampler above; anything else raises."""
    P = convert.algorithm_params(AlgorithmParams())
    assert pm.resolve_ncc_impl(P) == "svolume"
    assert pm.resolve_ncc_impl(dataclasses.replace(P, n_best=3)) == "direct"
    for impl in ("svolume", "direct"):
        for n_best in (1, 3):
            assert pm.resolve_ncc_impl(dataclasses.replace(
                P, ncc_impl=impl, n_best=n_best)) == impl
    assert convert.algorithm_params(
        AlgorithmParams(ncc_impl="pallas")).ncc_impl == "svolume"
    with pytest.raises(ValueError):
        pm.resolve_ncc_impl(dataclasses.replace(P, ncc_impl="pallas"))


# --- C8: odd-sided pyramid levels ------------------------------------------

HO, WO = 25, 33


@pytest.fixture(scope="module")
def odd():
    """A 25x33, 2-view scene (level 2 of a 50x66 image: both sides odd),
    a random plane state with costs drawn above most candidates', and
    the JAX s-volume the two sides share."""
    scene = make_scene(height=HO, width=WO, num_views=2, seed=6)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images, jnp.float32)
    jstats = _jit_stats(jncc.precompute_ref_stats)(imgs[0], jc, params)
    rng = np.random.default_rng(8)
    n, d = _planes(rng, jc, jstats.rays, scene, (HO, WO))
    cost = rng.uniform(0.3, 2.0, (HO, WO)).astype(np.float32)
    state = dict(normal=n, d=d, cost=cost,
                 ratio=np.zeros((HO, WO), np.float32),
                 best_view=np.full((HO, WO), -1, np.int32))
    idx = jnp.asarray([1], jnp.int32)
    s_lo, s_hi = jsv.s_range_for_depths(scene.depth_min, scene.depth_max,
                                        params.svolume_margin)
    counts = jsv.plane_counts(np.asarray(jc.A[idx]), np.asarray(jc.b[idx]),
                              HO, WO, s_lo, s_hi,
                              step_px=params.svolume_step_px)
    jvol = jax.jit(lambda im, A, b: jsv.build_svolume(
        im, A, b, s_lo, s_hi, counts))(imgs[idx], jc.A[idx], jc.b[idx])
    return dict(scene=scene, jc=jc, params=params, imgs=imgs,
                jstats=jstats, state=state, idx=idx, jvol=jvol)


@pytest.mark.parametrize("sampler", ["svolume", "direct"])
def test_odd_size_propagation_matches_jax(odd, sampler):
    """One propagation pass (parity 0) at 25x33 on the dense fallback
    against JAX's, from the same state: the other parity's pixels are
    untouched on both sides, the updating parity takes the same plane on
    at least 99% of its pixels, and there the cost agrees to the spec."""
    o = odd
    jc, params = o["jc"], o["params"]
    tc = convert.camera_set(jc, "cpu")
    tparams = convert.algorithm_params(params)
    tstats = ncc.precompute_ref_stats(torch.as_tensor(o["scene"].images[0]),
                                      tc, tparams)
    ids_t = torch.tensor([1])
    if sampler == "svolume":
        def jeval(normal, d, st, coords, parity=None):
            return jsv.multiview_cost_svolume(o["jvol"], o["idx"],
                                              jnp.ones((1,), bool), normal,
                                              d, st, params, parity=parity)
        cost_fn, pctx = pm.make_svolume_cost_fn(
            tstats, tc, HO, WO, convert.svolume(o["jvol"], "cpu"), ids_t,
            tparams)
    else:
        packed = {1: jsampling.pack_image(o["imgs"][1], jnp.bfloat16)}

        def jeval(normal, d, st, coords, parity=None):
            return jncc.multiview_cost(packed, (1,), jc, normal, d, st,
                                       params, coords=coords)
        cost_fn, pctx = pm.make_direct_cost_fn(
            tstats, tc, HO, WO, torch.as_tensor(o["scene"].images), ids_t,
            tparams)
    assert pctx is None
    jcost_fn, jpctx = jpm._make_cost_and_ctx(o["jstats"], jc, HO, WO, jeval)
    assert jpctx is None
    st = o["state"]
    jstate = jpm.PlaneState(**{k: jnp.asarray(v) for k, v in st.items()})
    out_j = jax.jit(lambda s_: jpm._propagation_pass(
        s_, 0, jcost_fn, jc, params))(jstate)
    tstate = pm.PlaneState(**{k: torch.as_tensor(v) for k, v in st.items()})
    out_t = pm._propagation_pass(tstate, 0, cost_fn, tc, tparams, pctx)

    upd = np.asarray(jcb.parity_mask(HO, WO, 0))
    dj, dt = np.asarray(out_j.d), out_t.d.numpy()
    assert (dt[~upd] == st["d"][~upd]).all()
    assert (dj[~upd] == st["d"][~upd]).all()
    moved = upd & (dj != st["d"])
    assert moved.sum() > 0.3 * upd.sum()
    same = (np.isclose(dt, dj, rtol=1e-6, atol=0)
            & (np.abs(out_t.normal.numpy() - np.asarray(out_j.normal))
               .max(-1) < 1e-6))
    assert same[upd].mean() > 0.99, float(same[upd].mean())
    cj, ct = np.asarray(out_j.cost), out_t.cost.numpy()
    both = same & upd
    assert np.quantile(np.abs(ct - cj)[both], 0.99) < TOL
    sharp = both & (ct < 0.99)
    assert (out_t.best_view.numpy() == np.asarray(out_j.best_view))[
        sharp].mean() > 0.99


def test_odd_size_process_view_completes(tmp_path):
    """process_view of a 50x66 scene (level 2 is 25x33) runs on the CPU,
    where it raised before, with a finite depth map of the image's shape."""
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams as TorchParams
    root = make_scene(height=50, width=66, num_views=3,
                      seed=0).export(tmp_path / "scene")
    scene = pipeline.load_scene(root)
    res = pipeline.process_view(
        scene, 0, TorchParams(iterations=1, weak_text_num=25, hough_thr=12,
                              min_line_length=12, max_line_gap=3,
                              ransac_iters=100, ransac_anneal_rounds=10,
                              wmf_iters=1, wmf_final_iters=1),
        device="cpu")
    assert res.depth.shape == (50, 66) and np.isfinite(res.depth).all()


# --- PatchMatch on the direct and colour paths -----------------------------

@pytest.mark.parametrize("color", [False, True])
def test_direct_patchmatch_accuracy_matches_jax(color):
    """run_patchmatch at 48x64, 2 sources, 2 iterations, on the direct
    sampler (n_best 2) or the colour one: both packages' median relative
    depth error on interior pixels stays below 0.03 on the same inputs
    (tests/test_ncc_color.py:81's bound; the random streams differ, so
    the bound is on accuracy, not on values)."""
    scene = make_scene(height=H, width=W, num_views=3, seed=0)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    params = AlgorithmParams(
        iterations=2, color_processing=color,
        n_best=1 if color else 2).with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    rgb = color_from_gray(scene.images)
    gt = scene.depth[0]
    ok = np.isfinite(gt)
    interior = np.zeros_like(ok)
    interior[6:-6, 6:-6] = ok[6:-6, 6:-6]

    def median_rel(depth):
        return float(np.median((np.abs(depth - gt) / np.where(ok, gt, 1.0))
                               [interior]))

    js = jpm.run_patchmatch(jax.random.PRNGKey(0),
                            jnp.asarray(scene.images), (1, 2), jc,
                            params, imgs_color=jnp.asarray(rgb))
    tc = convert.camera_set(jc, "cpu")
    ts = pm.run_patchmatch(torch.Generator().manual_seed(0),
                           torch.as_tensor(scene.images), (1, 2), tc,
                           convert.algorithm_params(params),
                           imgs_color=torch.as_tensor(rgb))
    errs = (median_rel(np.asarray(jpm.depth_map(js, jc))),
            median_rel(pm.depth_map(ts, tc).numpy()))
    assert max(errs) < 0.03, errs


# --- CLI --------------------------------------------------------------------

def test_cli_color_and_n_best_exit_0(tmp_path):
    """`gipuma -color_processing --n_best 3` and `scene -color_processing`
    run on the CPU and exit 0; under -color_processing the PLY's vertex
    colours are the RGB input (3-channel PFM views)."""
    from tsar_mvs_tpu_torch import cli
    from tsar_mvs_tpu_torch.utils import pfm, ply
    scene = make_scene(height=H, width=W, num_views=3, seed=1)
    root = scene.export(tmp_path / "scene")
    rgb = color_from_gray(scene.images)
    for v in range(3):
        (root / "images" / f"{v:08d}.png").unlink()
        pfm.write_pfm(root / "images" / f"{v:08d}.pfm",
                      rgb[v].transpose(1, 2, 0))
    cpu = ["--device", "cpu"]
    line = ["00000000.pfm", "00000001.pfm", "00000002.pfm", "-mslp_folder",
            str(root), "-no_display", "--iterations=1", *cpu]
    # View 0 lands in results/, so the scene run below resumes after it.
    assert cli.main(line + ["-color_processing", "--n_best=3"]) == 0
    assert cli.main(["scene", str(root), "-color_processing", "--resume",
                     "--iterations", "1", *cpu]) == 0
    for v in range(3):
        colors = ply.read_ply(root / "results" / f"{v:08d}"
                              / "TSAR_model.ply")[2]
        np.testing.assert_array_equal(
            colors,
            rgb[v].transpose(1, 2, 0).reshape(-1, 3).astype(np.uint8))


# --- kernel B3 on the card --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("parity,V,C,n_best,color,box", [
    (None, 4, 1, 1, False, (11, 11)), (0, 4, 4, 3, False, (11, 11)),
    (1, 3, 4, 1, True, (11, 11)), (0, 1, 1, 2, True, (11, 11)),
    (1, 4, 4, 1, False, (7, 5)), (None, 3, 1, 3, True, (7, 5)),
    (0, 7, 1, 1, False, (11, 11)), (None, 7, 4, 3, True, (11, 11)),
    (1, 9, 1, 1, False, (11, 11)), (0, 9, 1, 3, True, (11, 11)),
    (None, 9, 3, 1, False, (7, 5)), (1, 7, 8, 1, True, (11, 11)),
    (0, 7, 4, 5, False, (11, 11)), (None, 7, 1, 5, True, (11, 11))])
def test_b3_kernel_matches_plain_on_card(setup, parity, V, C, n_best, color,
                                         box):
    """Kernel B3 against its plain version on the card: same packed
    sources, same random candidates, an invalid one included; cost and
    ratio equal to the bit, best view equal off ties. The 7x5 window takes
    the kernel's generic window loop. More than four views repeat the
    scene's four sources under warp factors moved by 0.2% a round (seven
    views fill one group at one candidate, nine more than one); eight
    candidates in colour take the kernel's largest instance, and n_best 5
    with seven views its 32-entry aggregation. Needs an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = setup
    dev = torch.device("cuda")
    tparams = dataclasses.replace(s["tparams"], box_hsize=box[0],
                                  box_vsize=box[1], n_best=n_best)
    tc = convert.camera_set(s["jc"], dev)
    imgs = torch.as_tensor(s["rgb"] if color else s["scene"].images,
                           device=dev)
    st = (nc.precompute_ref_stats_color(imgs[0], tc, tparams) if color
          else ncc.precompute_ref_stats(imgs[0], tc, tparams))
    if parity is not None:
        st = (nc.compress_stats_color(st, parity) if color
              else ncc.compress_stats(st, parity))
    n_np, d_np = ((s["n"][:C], s["d"][:C]) if C <= 4 else _planes(
        np.random.default_rng(C), s["jc"], s["jstats"].rays, s["scene"],
        (C, H, W)))
    n = torch.as_tensor(n_np, device=dev)
    d = torch.as_tensor(d_np, device=dev).clone()
    d[-1, ::4] = 0.0
    if parity is not None:
        n, d = cb.parity_compress_vec(n, parity), cb.parity_compress(d,
                                                                     parity)
    src = torch.as_tensor([1 + k % 4 for k in range(V)], device=dev)
    scale = torch.as_tensor([1.0 + 0.002 * (k // 4) for k in range(V)],
                            device=dev)
    views = cuda_direct.make_views(imgs[src], tc.A[src] * scale[:, None, None],
                                   tc.b[src] * scale[:, None],
                                   torch.arange(1, V + 1, device=dev))
    args = (views, *ncc.plane_scalars(n, d, st), st, tparams, parity)
    before = trace.counter("launches.b3")
    mk = cuda_direct.multiview_cost_direct(*args)
    mp = cuda_direct.multiview_cost_direct_plain(*args)
    torch.cuda.synchronize()
    assert trace.counter("launches.b3") == before + 1
    np.testing.assert_array_equal(mk.cost.cpu().numpy(),
                                  mp.cost.cpu().numpy())
    np.testing.assert_array_equal(mk.ratio.cpu().numpy(),
                                  mp.ratio.cpu().numpy())
    untied = (mk.cost == mp.cost) & (mp.ratio != 1.0)
    assert torch.equal(mk.best_view[untied], mp.best_view[untied])
