"""Port parity for the s-volume: plane counts (exact, they set plane
spacing and so accuracy), plane scalars, and kernel B2's plain version
against the JAX gather build (`build_svolume(..., warp_plans=None)`).

Volume tolerance, in intensity levels: median |delta| 0, q99.9 <= 1.0,
max <= 2.0. Both sides round the interpolated sample to bf16; float32
differences of order 1e-7 in q can flip that rounding by one bf16 step,
which is at most 1.0 for 8-bit intensities (below 256)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.models import patchmatch as jpm
from tsar_mvs_tpu.ops import ncc as jncc
from tsar_mvs_tpu.ops import svolume as jsv
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.ops import cuda_warp, ncc
from tsar_mvs_tpu_torch.ops import svolume as sv

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(scene):
    kw = dict(depth_min=scene.depth_min, depth_max=scene.depth_max)
    jc = jgeo.build_camera_set(list(scene.P), **kw)
    tc = geo.build_camera_set(list(scene.P), device="cpu", **kw)
    params = AlgorithmParams().with_depth_range(scene.depth_min,
                                                scene.depth_max,
                                                float(tc.f))
    return jc, tc, params


def test_plane_counts_match(scene, setup):
    jc, tc, params = setup
    H, W = scene.images.shape[1:]
    assert sv.s_range_for_depths(2.0, 9.0, 0.125) == \
        jsv.s_range_for_depths(2.0, 9.0, 0.125)
    view_ids = (1, 2, 3, 4)
    tparams = convert.algorithm_params(params)
    assert pm.svolume_plane_counts(tc, view_ids, H, W, tparams) == \
        jpm.svolume_plane_counts(jc, view_ids, H, W, params)
    # Scene-shared counts with a budget small enough to coarsen the step.
    tight = params.__class__(**{**params.__dict__, "svolume_budget_mb": 1})
    cams_j = [jgeo.build_camera_set(list(scene.P[[r] + [v for v in range(5)
                                                       if v != r]]),
                                    depth_min=scene.depth_min,
                                    depth_max=scene.depth_max)
              for r in range(3)]
    cams_t = [convert.camera_set(c, "cpu") for c in cams_j]
    vids = [view_ids] * 3
    for p in (params, tight):
        assert pm.svolume_plane_counts_shared(
            cams_t, vids, H, W, convert.algorithm_params(p)) == \
            jpm.svolume_plane_counts_shared(cams_j, vids, H, W, p)


def test_plane_scalars_match(scene, setup):
    jc, tc, params = setup
    H, W = scene.images.shape[1:]
    rng = np.random.default_rng(3)
    n = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    d = rng.uniform(-6, -2, (2, H, W)).astype(np.float32)
    jstats = jncc.precompute_ref_stats(jnp.asarray(scene.images[0]), jc,
                                       params)
    tstats = ncc.precompute_ref_stats(torch.as_tensor(scene.images[0]), tc,
                                      convert.algorithm_params(params))
    for a, b in zip(sv.plane_scalars(torch.as_tensor(n), torch.as_tensor(d),
                                     tstats),
                    jsv.plane_scalars(jnp.asarray(n), jnp.asarray(d),
                                      jstats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("cam_scale", [1.0, 2.0])
def test_warp_plain_matches_gather_build(scene, cam_scale):
    kw = dict(cam_scale=cam_scale, depth_min=scene.depth_min,
              depth_max=scene.depth_max)
    jc = jgeo.build_camera_set(list(scene.P), **kw)
    tc = geo.build_camera_set(list(scene.P), device="cpu", **kw)
    imgs = scene.images
    if cam_scale == 2.0:
        imgs = np.asarray(jpm.downsample_2x(jnp.asarray(imgs)))
    H, W = imgs.shape[1:]
    idx = [1, 4]
    s_lo, s_hi = jsv.s_range_for_depths(scene.depth_min, scene.depth_max,
                                        0.125)
    counts = jsv.plane_counts(np.asarray(jc.A)[idx], np.asarray(jc.b)[idx],
                              H, W, s_lo, s_hi, step_px=2.0)
    jvol = jsv.build_svolume(jnp.asarray(imgs[idx]), jc.A[jnp.asarray(idx)],
                             jc.b[jnp.asarray(idx)], s_lo, s_hi, counts,
                             warp_plans=None)
    tvol = sv.build_svolume(torch.as_tensor(imgs[idx]), tc.A[idx],
                            tc.b[idx], s_lo, s_hi, counts)
    assert tvol.s_lo == pytest.approx(float(jvol.s_lo), abs=0)
    for k in range(len(idx)):
        assert tvol.inv_ds[k] == float(jvol.inv_ds[k])
        assert tvol.data[k].dtype == torch.bfloat16
        delta = np.abs(tvol.data[k].float().numpy()
                       - np.asarray(jvol.data[k], np.float32))
        assert np.median(delta) == 0.0
        assert np.quantile(delta, 0.999) <= 1.0, np.quantile(delta, 0.999)
        assert delta.max() <= 2.0, delta.max()


def test_warp_plain_nan_coordinates_stay_in_bounds():
    """At w = u_z - b_z s = 0 the warp is non-finite: q = (x, y) * inf.
    The plain build clamps +inf to the border and reads 0 for NaN (0 * inf
    at x = 0 or y = 0) instead of failing on an out-of-range index."""
    src = torch.arange(12.0).reshape(3, 4)
    A = torch.eye(3)
    b = torch.tensor([0.0, 0.0, 1.0])
    vol = cuda_warp.build_svolume_view_plain(src, A, b, 1.0, 1.0, 2)
    assert vol.shape == (2, 3, 4)
    assert torch.isfinite(vol.float()).all()
    iy = torch.tensor([0, 2, 2])[:, None]
    ix = torch.tensor([0, 3, 3, 3])[None, :]
    assert torch.equal(vol[0].float(), src[iy, ix])


@pytest.mark.cuda
def test_warp_kernel_matches_plain_on_card(scene, setup):
    """Kernel B2 against its plain version on the card; needs an NVIDIA
    GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tc, params = setup
    dev = torch.device("cuda")
    s_lo, s_hi = sv.s_range_for_depths(params.depth_min, params.depth_max,
                                       params.svolume_margin)
    S = 40
    src = torch.as_tensor(scene.images[3], device=dev)
    A, b = tc.A[3].to(dev), tc.b[3].to(dev)
    ds = (s_hi - s_lo) / (S - 1)
    before = cuda_warp.LAUNCHES
    vk = cuda_warp.build_svolume_view(src, A, b, s_lo, ds, S)
    vp = cuda_warp.build_svolume_view_plain(src, A, b, s_lo, ds, S)
    torch.cuda.synchronize()
    assert cuda_warp.LAUNCHES == before + 1
    delta = (vk.float() - vp.float()).abs().cpu().numpy()
    assert np.median(delta) == 0.0
    assert np.quantile(delta, 0.999) <= 1.0
    assert delta.max() <= 2.0
