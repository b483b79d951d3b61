"""Port parity for the NCC cost: reference statistics, kernel B1's plain
version against the JAX oracle `svolume.svolume_cost_ab` (same volume,
same plane field) and against the JAX Pallas kernel in interpret mode,
the streaming view aggregation, and the reverse (confidence) cost.

Cost tolerance (the spec of tests/test_pallas_ncc.py:44-46): on pixels
where either cost is below 0.99, median |delta| < 5e-4 and q99 < 5e-3;
fewer than 1% of all pixels off by more than 0.1. The sums run in another
order (per offset here, per plane in the oracle's scan), and NCC divides by
sqrt(var_src), which amplifies that noise without bound as var_src -> 0."""

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
    tc = convert.camera_set(jc)
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images, jnp.float32)
    jstats = jncc.precompute_ref_stats(imgs[0], jc, params)
    tstats = ncc.precompute_ref_stats(torch.as_tensor(scene.images[0]), tc,
                                      params)
    idx = jnp.asarray([1, 2], jnp.int32)
    s_lo, s_hi = jsv.s_range_for_depths(scene.depth_min, scene.depth_max,
                                        params.svolume_margin)
    counts = jsv.plane_counts(np.asarray(jc.A[idx]), np.asarray(jc.b[idx]),
                              H, W, s_lo, s_hi,
                              step_px=params.svolume_step_px)
    jvol = jsv.build_svolume(imgs[idx], jc.A[idx], jc.b[idx], s_lo, s_hi,
                             counts)
    tvol = convert.svolume(jvol)
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
    return dict(scene=scene, jc=jc, tc=tc, params=params, imgs=imgs,
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
    ct = sv.svolume_cost(s["tvol"], 0, t0, tx, ty, tst, s["params"],
                         parity).numpy()
    assert ct.shape == cj.shape
    assert_cost_agreement(ct, cj)

    ids = torch.tensor([1, 2])
    mt = sv.multiview_cost_svolume(s["tvol"], ids, torch.as_tensor(n),
                                   torch.as_tensor(d), tst, s["params"],
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
                                   tst, s["params"], parity)
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
                                     s["params"], parity)
    d_half = d.clone()
    d_half[:, ::3] = 0.0
    paired = sv.multiview_cost_svolume(
        s["tvol"], ids, torch.stack([n, n, n]),
        torch.stack([d, torch.zeros_like(d), d_half]), tst, s["params"],
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
                           s["params"])
    cj = np.asarray(cj)
    ct = ct.numpy()
    assert (ct[best_view < 0] == 0).all()
    assert_cost_agreement(ct, cj)


def test_window_offsets_match():
    for p in (AlgorithmParams(), AlgorithmParams(box_hsize=7, box_vsize=5)):
        assert ncc.window_offsets(p) == jncc.window_offsets(p)
    assert jax.default_backend() == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("parity", [None, 0, 1])
def test_kernel_matches_plain_on_card(setup, parity):
    """Kernel B1 against its plain version on the card (same volume, same
    candidates, an invalid one included); needs an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = setup
    dev = torch.device("cuda")
    st = s["tstats"] if parity is None else ncc.compress_stats(s["tstats"],
                                                               parity)
    st = ncc.RefStats(*(f.to(dev) for f in st))
    n, d = torch.as_tensor(s["n"]), torch.as_tensor(s["d"]).clone()
    d[1, ::4] = 0.0
    if parity is not None:
        n, d = cb.parity_compress_vec(n, parity), cb.parity_compress(d,
                                                                     parity)
    s0, sx, sy = sv.plane_scalars(n.to(dev), d.to(dev), st)
    vol = s["tvol"].data[0].to(dev)
    before = cuda_ncc.LAUNCHES
    ck = cuda_ncc.svolume_cost(vol, s["tvol"].s_lo, s["tvol"].inv_ds[0], s0,
                               sx, sy, st, s["params"], parity)
    cp = cuda_ncc.svolume_cost_plain(vol, s["tvol"].s_lo,
                                     s["tvol"].inv_ds[0], s0, sx, sy, st,
                                     s["params"], parity)
    torch.cuda.synchronize()
    assert cuda_ncc.LAUNCHES == before + 1
    assert_cost_agreement(ck.cpu().numpy(), cp.cpu().numpy())
