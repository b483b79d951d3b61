"""Port parity for the NCC cost: reference statistics, kernel B1's plain
version against the JAX oracle `svolume.svolume_cost_ab` (same volume,
same plane field) and against the JAX Pallas kernel in interpret mode,
the streaming view aggregation, and the reverse (confidence) cost.

Cost tolerance (the spec of tests/test_pallas_ncc.py:44-46): on pixels
where either cost is below 0.99, median |delta| < 5e-4 and q99 < 5e-3;
fewer than 1% of all pixels off by more than 0.1. The sums run in another
order (per offset here, per plane in the oracle's scan), and NCC divides by
sqrt(var_src), which amplifies that noise without bound as var_src -> 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.ops import checkerboard as jcb
from tsar_mvs_tpu.ops import ncc as jncc
from tsar_mvs_tpu.ops import svolume as jsv
from tsar_mvs_tpu.utils.synthetic import make_scene
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import cuda_ncc, ncc
from tsar_mvs_tpu_torch.ops import svolume as sv
from tsar_mvs_tpu_torch import trace

torch.set_num_threads(2)
H, W = 64, 256


def assert_cost_agreement(c_t, c_j):
    delta = np.abs(c_t - c_j)
    sharp = np.minimum(c_t, c_j) < 0.99
    assert sharp.mean() > 0.3
    d = delta[sharp]
    assert np.quantile(d, 0.5) < 5e-4, float(np.quantile(d, 0.5))
    assert np.quantile(d, 0.99) < 5e-3, float(np.quantile(d, 0.99))
    assert (delta > 0.1).mean() < 0.01, float((delta > 0.1).mean())


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(height=H, width=W, num_views=3, seed=2)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    tc = convert.camera_set(jc, "cpu")
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images, jnp.float32)
    jstats = jncc.precompute_ref_stats(imgs[0], jc, params)
    tparams = convert.algorithm_params(params)
    tstats = ncc.precompute_ref_stats(torch.as_tensor(scene.images[0]), tc,
                                      tparams)
    idx = jnp.asarray([1, 2], jnp.int32)
    s_lo, s_hi = jsv.s_range_for_depths(scene.depth_min, scene.depth_max,
                                        params.svolume_margin)
    counts = jsv.plane_counts(np.asarray(jc.A[idx]), np.asarray(jc.b[idx]),
                              H, W, s_lo, s_hi,
                              step_px=params.svolume_step_px)
    jvol = jsv.build_svolume(imgs[idx], jc.A[idx], jc.b[idx], s_lo, s_hi,
                             counts)
    tvol = convert.svolume(jvol, "cpu")
    # A random plane field (n on the camera-facing hemisphere, depth
    # inside the scene range), made with numpy and handed to both sides.
    rng = np.random.default_rng(4)
    n = rng.standard_normal((2, H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vv = np.asarray(jgeo.view_vectors(jc, H, W))
    n = np.where(np.sum(n * vv, -1, keepdims=True) > 0, -n, n)
    depth = rng.uniform(scene.depth_min * 1.05, scene.depth_max * 0.95,
                        (2, H, W))
    rays = np.asarray(jstats.rays)
    d = -depth * np.sum(n * rays, -1)
    return dict(scene=scene, jc=jc, tc=tc, params=params, tparams=tparams,
                imgs=imgs,
                jstats=jstats, tstats=tstats, jvol=jvol, tvol=tvol,
                counts=counts, s_lo=s_lo, n=n.astype(np.float32),
                d=d.astype(np.float32))


def test_ref_stats_match(setup):
    j, t = setup["jstats"], setup["tstats"]
    for field in ncc.RefStats._fields:
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)), atol=1e-5,
                                   rtol=1e-5, err_msg=field)
    for parity in (0, 1):
        jc_ = jncc.compress_stats(j, parity)
        tc_ = ncc.compress_stats(t, parity)
        np.testing.assert_allclose(tc_.weights.numpy(),
                                   np.asarray(jc_.weights), atol=1e-5)
        np.testing.assert_allclose(tc_.rays.numpy(), np.asarray(jc_.rays),
                                   atol=1e-5)


@pytest.mark.parametrize("parity", [None, 0, 1])
def test_plain_cost_matches_oracle(setup, parity):
    s = setup
    n, d = s["n"], s["d"]
    jst, tst = s["jstats"], s["tstats"]
    if parity is not None:
        n = np.array(jcb.parity_compress_vec(jnp.asarray(n), parity))
        d = np.array(jcb.parity_compress(jnp.asarray(d), parity))
        jst = jncc.compress_stats(jst, parity)
        tst = ncc.compress_stats(tst, parity)
    j0, jx, jy = jsv.plane_scalars(jnp.asarray(n), jnp.asarray(d), jst)
    t0, tx, ty = sv.plane_scalars(torch.as_tensor(n), torch.as_tensor(d),
                                  tst)
    cj = np.asarray(jsv.svolume_cost_ab(s["jvol"], 0, j0, jx, jy, jst,
                                        s["params"], parity))
    ct = cuda_ncc.svolume_cost_plain(
        s["tvol"].data[0], s["tvol"].s_lo, s["tvol"].inv_ds[0], t0, tx, ty,
        tst, s["tparams"], parity).numpy()
    assert ct.shape == cj.shape
    assert_cost_agreement(ct, cj)

    ids = torch.tensor([1, 2])
    mt = sv.multiview_cost_svolume(s["tvol"], ids, torch.as_tensor(n),
                                   torch.as_tensor(d), tst, s["tparams"],
                                   parity)
    mj = jsv.multiview_cost_svolume(s["jvol"], jnp.asarray([1, 2]),
                                    jnp.ones((2,), bool), jnp.asarray(n),
                                    jnp.asarray(d), jst, s["params"],
                                    parity)
    assert_cost_agreement(mt.cost.numpy(), np.asarray(mj.cost))
    sharp = np.asarray(mj.cost) < 0.99
    assert (mt.best_view.numpy() == np.asarray(mj.best_view))[sharp].mean() \
        > 0.995


def test_plain_cost_matches_pallas_interpret(setup, monkeypatch):
    """Second oracle: the JAX Pallas kernel itself, in interpret mode, on
    its own parity-split halo-padded volumes."""
    monkeypatch.setenv("TSAR_PALLAS_INTERPRET", "1")
    from tsar_mvs_tpu.ops import pallas_ncc as pn
    s = setup
    parity = 1
    vols_p = pn.prepare_parity_volumes(s["jvol"].data, H, W)
    jst = jncc.compress_stats(s["jstats"], parity)
    tst = ncc.compress_stats(s["tstats"], parity)
    n = np.array(jcb.parity_compress_vec(jnp.asarray(s["n"][0]), parity))
    d = np.array(jcb.parity_compress(jnp.asarray(s["d"][0]), parity))
    mj = pn.multiview_cost_pallas(vols_p[parity], s["counts"], s["s_lo"],
                                  s["jvol"].inv_ds, jnp.asarray([1, 2]),
                                  jnp.ones((2,), bool), jnp.asarray(n),
                                  jnp.asarray(d), jst, s["params"], parity)
    mt = sv.multiview_cost_svolume(s["tvol"], torch.tensor([1, 2]),
                                   torch.as_tensor(n), torch.as_tensor(d),
                                   tst, s["tparams"], parity)
    assert_cost_agreement(mt.cost.numpy(), np.asarray(mj.cost))


def test_invalid_candidates_cost_max_and_do_not_leak(setup):
    """Border banks pad d = 0 (non-finite plane scalars). Such a candidate
    costs exactly cost_max, and a valid candidate evaluated beside it is
    unchanged from its solo evaluation (tests/test_pallas_ncc.py:213)."""
    s = setup
    parity = 0
    tst = ncc.compress_stats(s["tstats"], parity)
    n = cb.parity_compress_vec(torch.as_tensor(s["n"][0]), parity)
    d = cb.parity_compress(torch.as_tensor(s["d"][0]), parity)
    ids = torch.tensor([1, 2])
    solo = sv.multiview_cost_svolume(s["tvol"], ids, n[None], d[None], tst,
                                     s["tparams"], parity)
    d_half = d.clone()
    d_half[:, ::3] = 0.0
    paired = sv.multiview_cost_svolume(
        s["tvol"], ids, torch.stack([n, n, n]),
        torch.stack([d, torch.zeros_like(d), d_half]), tst, s["tparams"],
        parity)
    np.testing.assert_allclose(paired.cost[0].numpy(), solo.cost[0].numpy(),
                               atol=1e-5)
    assert (paired.cost[1] == s["params"].cost_max).all()
    assert (paired.cost[2][:, ::3] == s["params"].cost_max).all()
    assert (paired.best_view[1] == -1).all()


def test_rl_cost_fused_matches_jax(setup):
    s = setup
    rng = np.random.default_rng(11)
    best_view = rng.integers(-1, 3, (H, W)).astype(np.int32)
    best_view[best_view == 0] = 1
    n, d = s["n"][1], s["d"][1]
    cj = jncc.rl_cost_fused(s["imgs"][0], s["imgs"], jnp.asarray(best_view),
                            (1, 2), s["jc"], jnp.asarray(n), jnp.asarray(d),
                            s["params"])
    ct = ncc.rl_cost_fused(torch.as_tensor(s["scene"].images[0]),
                           torch.as_tensor(s["scene"].images),
                           torch.as_tensor(best_view), (1, 2), s["tc"],
                           torch.as_tensor(n), torch.as_tensor(d),
                           s["tparams"])
    cj = np.asarray(cj)
    ct = ct.numpy()
    assert (ct[best_view < 0] == 0).all()
    assert_cost_agreement(ct, cj)


def test_window_offsets_match():
    for p in (AlgorithmParams(), AlgorithmParams(box_hsize=7, box_vsize=5)):
        assert ncc.window_offsets(convert.algorithm_params(p)) == \
            jncc.window_offsets(p)
    assert jax.default_backend() == "cpu"


@pytest.fixture(scope="module")
def wide():
    """An 8-view scene (7 sources with unequal plane counts) with 8
    random planes per pixel, for the multi-view evaluation."""
    Hw, Ww = 48, 96
    scene = make_scene(height=Hw, width=Ww, num_views=8, seed=5)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images, jnp.float32)
    jstats = jncc.precompute_ref_stats(imgs[0], jc, params)
    idx = jnp.arange(1, 8, dtype=jnp.int32)
    s_lo, s_hi = jsv.s_range_for_depths(scene.depth_min, scene.depth_max,
                                        params.svolume_margin)
    counts = jsv.plane_counts(np.asarray(jc.A[idx]), np.asarray(jc.b[idx]),
                              Hw, Ww, s_lo, s_hi,
                              step_px=params.svolume_step_px)
    assert len(set(counts)) > 1
    jvol = jsv.build_svolume(imgs[idx], jc.A[idx], jc.b[idx], s_lo, s_hi,
                             counts)
    rng = np.random.default_rng(9)
    n = rng.standard_normal((8, Hw, Ww, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vv = np.asarray(jgeo.view_vectors(jc, Hw, Ww))
    n = np.where(np.sum(n * vv, -1, keepdims=True) > 0, -n, n)
    depth = rng.uniform(scene.depth_min * 1.05, scene.depth_max * 0.95,
                        (8, Hw, Ww))
    d = -depth * np.sum(n * np.asarray(jstats.rays), -1)
    return dict(jvol=jvol, tvol=convert.svolume(jvol, "cpu"), jstats=jstats,
                tstats=convert.ref_stats(jstats, "cpu"),
                tcams=convert.camera_set(jc, "cpu"), params=params,
                tparams=convert.algorithm_params(params),
                n=n.astype(np.float32), d=d.astype(np.float32))


def _subset(vol, V):
    """The first V views of an SVolume (either package's)."""
    return vol._replace(data=tuple(vol.data[:V]),
                        inv_ds=tuple(vol.inv_ds[:V]))


TOL = 5e-3  # the q99 bound of assert_cost_agreement


@pytest.mark.parametrize("parity,V,C", [(None, 1, 1), (0, 3, 4), (1, 7, 8),
                                        (0, 7, 1), (1, 1, 4), (None, 3, 8)])
def test_multiview_plain_matches_jax(wide, parity, V, C):
    """The fused evaluation's plain version (per-view plain costs through
    the streaming top-2) against JAX's multiview_cost_svolume: cost within
    the oracle test's tolerance; best_view equal wherever the winner is
    clear (the two sides' best and second-best costs differ by more than
    that tolerance on both, up to 0.1% of such pixels); ratio within it
    there too."""
    w = wide
    n, d = w["n"][:C], w["d"][:C]
    jst, tst = w["jstats"], w["tstats"]
    if parity is not None:
        n = np.array(jcb.parity_compress_vec(jnp.asarray(n), parity))
        d = np.array(jcb.parity_compress(jnp.asarray(d), parity))
        jst = jncc.compress_stats(jst, parity)
        tst = ncc.compress_stats(tst, parity)
    ids = list(range(1, V + 1))
    mj = jsv.multiview_cost_svolume(
        _subset(w["jvol"], V), jnp.asarray(ids), jnp.ones((V,), bool),
        jnp.asarray(n), jnp.asarray(d), jst, w["params"], parity)
    mt = sv.multiview_cost_svolume(
        _subset(w["tvol"], V), torch.tensor(ids), torch.as_tensor(n),
        torch.as_tensor(d), tst, w["tparams"], parity)
    cj, ct = np.asarray(mj.cost), mt.cost.numpy()
    assert ct.shape == cj.shape and mt.best_view.dtype == torch.int32
    assert_cost_agreement(ct, cj)
    rj, rt = np.asarray(mj.ratio), mt.ratio.numpy()
    if V == 1:
        clear = np.minimum(cj, ct) < jncc.MAXCOST - TOL
        assert (rt[ct < jncc.MAXCOST] == 1.0).all()
    else:
        # second = best / ratio; a clear winner leads by more than TOL.
        lead_j = np.where(rj > 0, cj / np.maximum(rj, 1e-12) - cj, 0.0)
        lead_t = np.where(rt > 0, ct / np.maximum(rt, 1e-12) - ct, 0.0)
        clear = (np.minimum(lead_j, lead_t) > 2 * TOL) \
            & (np.maximum(cj, ct) < jncc.MAXCOST - TOL)
    assert clear.mean() > 0.3
    # The cost tolerance allows rare outliers (a per-view cost off by more
    # than 0.1 on up to 1% of pixels), and one of those can flip a winner.
    same = (mt.best_view.numpy() == np.asarray(mj.best_view))[clear]
    assert same.mean() > 0.999, float(same.mean())
    sharp = clear & (np.minimum(ct, cj) < 0.99)
    assert np.quantile(np.abs(rt - rj)[sharp], 0.99) < 2e-2


def _toy_multiview(costs, ids):
    """aggregate_streaming and a plain numpy top-2 on given per-view
    costs (V, ...)."""
    costs = np.asarray(costs, np.float32)
    mv = ncc.aggregate_streaming(
        [lambda v=v: torch.as_tensor(costs[v]) for v in range(len(costs))],
        torch.tensor(ids))
    return mv


def test_aggregation_ties_and_all_invalid():
    """The streaming top-2's corner cases, as the kernel reproduces them:
    the earlier view wins a tie (strict <) and the ratio is then 1; a
    pixel with no view under MAXCOST gets view -1 and ratio 0; with one
    view second = best; ids come from the table."""
    ids = [5, 2, 9]
    costs = [[0.5, 2.0, 0.7, 0.3], [0.5, 2.0, 0.2, 0.3], [0.9, 2.0, 0.2, 0.1]]
    mv = _toy_multiview(costs, ids)
    np.testing.assert_array_equal(mv.best_view.numpy(), [5, -1, 2, 9])
    np.testing.assert_allclose(mv.cost.numpy(), [0.5, 2.0, 0.2, 0.1])
    np.testing.assert_allclose(mv.ratio.numpy(), [1.0, 0.0, 1.0, 0.1 / 0.3],
                               rtol=1e-6)
    one = _toy_multiview(costs[:1], ids[:1])
    np.testing.assert_array_equal(one.best_view.numpy(), [5, -1, 5, 5])
    np.testing.assert_allclose(one.ratio.numpy(), [1.0, 0.0, 1.0, 1.0])


def test_multiview_nonfinite_scalars_and_all_invalid(wide):
    """Non-finite plane scalars (d = 0) through the fused evaluation: the
    candidate costs cost_max against every view, so the pixel has no
    valid view (best_view -1, ratio 0), for V = 1 and V = 7; NaN normals
    do the same; finite candidates beside them are untouched."""
    w = wide
    parity = 1
    tst = ncc.compress_stats(w["tstats"], parity)
    n = cb.parity_compress_vec(torch.as_tensor(w["n"][:3]), parity).clone()
    d = cb.parity_compress(torch.as_tensor(w["d"][:3]), parity).clone()
    d[1] = 0.0
    n[2, ::2] = float("nan")
    for V in (1, 7):
        vol = _subset(w["tvol"], V)
        ids = torch.arange(1, V + 1)
        mv = sv.multiview_cost_svolume(vol, ids, n, d, tst, w["tparams"],
                                       parity)
        solo = sv.multiview_cost_svolume(vol, ids, n[:1], d[:1], tst,
                                         w["tparams"], parity)
        assert torch.equal(mv.cost[0], solo.cost[0])
        assert torch.equal(mv.best_view[0], solo.best_view[0])
        assert (mv.cost[1] == w["tparams"].cost_max).all()
        assert (mv.best_view[1] == -1).all() and (mv.ratio[1] == 0).all()
        assert (mv.cost[2, ::2] == w["tparams"].cost_max).all()
        assert (mv.best_view[2, ::2] == -1).all()
        assert torch.isfinite(mv.ratio).all()


@pytest.mark.cuda
@pytest.mark.parametrize("parity,V,C,box", [
    (None, 7, 1, (11, 11)), (0, 7, 8, (11, 11)), (1, 3, 4, (11, 11)),
    (0, 1, 1, (11, 11)), (0, 7, 4, (7, 5)), (None, 3, 1, (7, 5))])
def test_kernel_matches_plain_on_card(wide, parity, V, C, box):
    """Kernel B1 (all views and the top-2 in one launch) against its plain
    version on the card: same volumes, same candidates, an invalid one
    included; cost and ratio to the spec, best_view equal off ties. The
    7x5 window takes the kernel's generic window loop. Needs an NVIDIA
    GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = wide
    dev = torch.device("cuda")
    tparams = dataclasses.replace(w["tparams"], box_hsize=box[0],
                                  box_vsize=box[1])
    st = ncc.precompute_ref_stats(w["tstats"].center, w["tcams"], tparams)
    if parity is not None:
        st = ncc.compress_stats(st, parity)
    st = ncc.RefStats(*(f.to(dev) for f in st))
    n = torch.as_tensor(w["n"][:C])
    d = torch.as_tensor(w["d"][:C]).clone()
    d[-1, ::4] = 0.0
    if parity is not None:
        n, d = cb.parity_compress_vec(n, parity), cb.parity_compress(d,
                                                                     parity)
    s0, sx, sy = sv.plane_scalars(n.to(dev), d.to(dev), st)
    vols = [v.to(dev) for v in w["tvol"].data[:V]]
    args = (vols, w["tvol"].s_lo, w["tvol"].inv_ds[:V],
            torch.arange(1, V + 1, device=dev), s0, sx, sy, st, tparams,
            parity)
    before = trace.counter("launches.b1")
    mk = cuda_ncc.multiview_cost(*args)
    mp = cuda_ncc.multiview_cost_plain(*args)
    torch.cuda.synchronize()
    assert trace.counter("launches.b1") == before + 1
    assert_cost_agreement(mk.cost.cpu().numpy(), mp.cost.cpu().numpy())
    untied = (mk.cost == mp.cost) & (mk.ratio != 1.0)
    assert torch.equal(mk.best_view[untied], mp.best_view[untied])
    np.testing.assert_allclose(mk.ratio.cpu().numpy(),
                               mp.ratio.cpu().numpy(), atol=1e-5)
