"""Port parity: tsar_mvs_tpu_torch.geometry against the JAX geometry and
the numpy oracles of tests/test_geometry.py. Float32 tolerance
rtol = atol = 1e-5 (same arithmetic order on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.models import view_selection as tvs
from tsar_mvs_tpu.models import view_selection as jvs

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def both(scene):
    kw = dict(depth_min=scene.depth_min, depth_max=scene.depth_max)
    return (jgeo.build_camera_set(list(scene.P), **kw),
            geo.build_camera_set(list(scene.P), device="cpu", **kw))


@pytest.mark.parametrize("cam_scale,rebase", [(1.0, True), (2.0, True),
                                              (1.0, False)])
def test_build_camera_set_matches_jax(scene, cam_scale, rebase):
    kw = dict(cam_scale=cam_scale, depth_min=scene.depth_min,
              depth_max=scene.depth_max, rebase=rebase)
    j = jgeo.build_camera_set(list(scene.P), **kw)
    t = geo.build_camera_set(list(scene.P), device="cpu", **kw)
    for field in jgeo.CameraSet._fields:
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)), **TOL,
                                   err_msg=field)


def test_decomposition_oracles(scene, rng):
    for _ in range(5):
        A = rng.standard_normal((3, 3))
        R_up, Q = geo.rq3(A)
        np.testing.assert_allclose(R_up @ Q, A, atol=1e-10)
        np.testing.assert_allclose(Q @ Q.T, np.eye(3), atol=1e-10)
    for v in range(scene.num_views):
        K, R, C = geo.decompose_projection(scene.P[v])
        np.testing.assert_allclose(K, scene.K, atol=1e-6)
        np.testing.assert_allclose(R, scene.R[v], atol=1e-8)
        np.testing.assert_allclose(C, -scene.R[v].T @ scene.t[v], atol=1e-8)


def test_plane_algebra_matches_jax(both):
    jc, tc = both
    H, W = 96, 128
    rng = np.random.default_rng(0)
    normal = rng.standard_normal((H, W, 3)) * 0.35
    normal[..., 2] = -1.0
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal.astype(np.float32)
    depth = rng.uniform(2.0, 10.0, (H, W)).astype(np.float32)

    j_rays = jgeo.pixel_rays(jc, H, W)
    t_rays = geo.pixel_rays(tc, H, W)
    np.testing.assert_allclose(t_rays.numpy(), np.asarray(j_rays), **TOL)
    np.testing.assert_allclose(geo.view_vectors(tc, H, W).numpy(),
                               np.asarray(jgeo.view_vectors(jc, H, W)),
                               **TOL)
    j_d = jgeo.plane_d_from_depth(jnp.asarray(normal), j_rays,
                                  jnp.asarray(depth))
    t_d = geo.plane_d_from_depth(torch.as_tensor(normal), t_rays,
                                 torch.as_tensor(depth))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), **TOL)

    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    j_depth = jgeo.depth_from_plane(jc, jnp.asarray(normal), j_d,
                                    jnp.asarray(xx), jnp.asarray(yy))
    t_depth = geo.depth_from_plane(tc, torch.as_tensor(normal), t_d,
                                   torch.as_tensor(xx), torch.as_tensor(yy))
    np.testing.assert_allclose(t_depth.numpy(), np.asarray(j_depth), **TOL)
    # The involution oracle of tests/test_geometry.py.
    rel = np.abs(t_depth.numpy() / depth - 1.0)
    assert np.quantile(rel, 0.999) < 2e-3

    for v in (0, 2):
        np.testing.assert_allclose(
            geo.backproject(tc, v, torch.as_tensor(xx), torch.as_tensor(yy),
                            torch.as_tensor(depth)).numpy(),
            np.asarray(jgeo.backproject(jc, v, jnp.asarray(xx),
                                        jnp.asarray(yy),
                                        jnp.asarray(depth))), **TOL)

    raw = rng.standard_normal((H, W, 3)).astype(np.float32)
    np.testing.assert_allclose(geo.normalize(torch.as_tensor(raw)).numpy(),
                               np.asarray(jgeo.normalize(jnp.asarray(raw))),
                               **TOL)
    vv = geo.view_vectors(tc, H, W)
    np.testing.assert_array_equal(
        geo.hemisphere_flip(torch.as_tensor(raw), vv).numpy(),
        np.asarray(jgeo.hemisphere_flip(jnp.asarray(raw),
                                        jnp.asarray(vv.numpy()))))
    np.testing.assert_allclose(geo.disparity_depth(150.0, 1.0,
                                                   geo.disparity_depth(
                                                       150.0, 1.0, depth)),
                               depth, rtol=1e-6)


def test_convert_camera_set_roundtrip(both):
    jc, tc = both
    conv = convert.camera_set(jc, "cpu")
    for field in geo.CameraSet._fields:
        np.testing.assert_array_equal(getattr(conv, field).numpy(),
                                      getattr(tc, field).numpy())


def test_select_views_angle_matches_jax(scene):
    P = list(scene.P)
    for ref in range(scene.num_views):
        assert tvs.select_views_angle(
            P, ref, scene.depth_min, scene.depth_max, max_views=2) == \
            jvs.select_views_angle(P, ref, scene.depth_min,
                                   scene.depth_max, max_views=2)
