"""Port parity: checkerboard candidate banks, parity packing and the
edge-clamped shift match the JAX package exactly (selects and copies)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu.ops import checkerboard as jcb
from tsar_mvs_tpu.ops import sampling as jsamp
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import sampling as samp

torch.set_num_threads(2)
H, W = 24, 34


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(5)
    normal = rng.standard_normal((H, W, 3)).astype(np.float32)
    d = rng.standard_normal((H, W)).astype(np.float32)
    # Ties in the stored cost exercise the strict-less running min.
    cost = rng.integers(0, 6, (H, W)).astype(np.float32) / 3.0
    cost[3, 5] = np.inf
    return normal, d, cost


def test_banks_match():
    assert cb.BANKS == jcb.BANKS


def test_select_candidates_exact(field):
    normal, d, cost = field
    j = jcb.select_candidates(jnp.asarray(normal), jnp.asarray(d),
                              jnp.asarray(cost))
    t = cb.select_candidates(torch.as_tensor(normal), torch.as_tensor(d),
                             torch.as_tensor(cost))
    np.testing.assert_array_equal(t.normal.numpy(), np.asarray(j.normal))
    np.testing.assert_array_equal(t.d.numpy(), np.asarray(j.d))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    # A bank subset is the tail of the full table.
    t4 = cb.select_candidates(torch.as_tensor(normal), torch.as_tensor(d),
                              torch.as_tensor(cost), cb.BANKS[4:])
    np.testing.assert_array_equal(t4.d.numpy(), np.asarray(j.d)[4:])


@pytest.mark.parametrize("parity", [0, 1])
def test_parity_pack_unpack_exact(field, parity):
    normal, d, _ = field
    rng = np.random.default_rng(parity)
    j_c = np.asarray(jcb.parity_compress(jnp.asarray(d), parity))
    t_c = cb.parity_compress(torch.as_tensor(d), parity).numpy()
    np.testing.assert_array_equal(t_c, j_c)
    jv = np.asarray(jcb.parity_compress_vec(jnp.asarray(normal), parity))
    tv = cb.parity_compress_vec(torch.as_tensor(normal), parity).numpy()
    np.testing.assert_array_equal(tv, jv)

    new = rng.standard_normal((2, H, W // 2)).astype(np.float32)
    old = rng.standard_normal((2, H, W)).astype(np.float32)
    np.testing.assert_array_equal(
        cb.parity_expand(torch.as_tensor(new), torch.as_tensor(old),
                         parity).numpy(),
        np.asarray(jcb.parity_expand(jnp.asarray(new), jnp.asarray(old),
                                     parity)))
    new_v = rng.standard_normal((H, W // 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        cb.parity_expand_vec(torch.as_tensor(new_v),
                             torch.as_tensor(normal), parity).numpy(),
        np.asarray(jcb.parity_expand_vec(jnp.asarray(new_v),
                                         jnp.asarray(normal), parity)))
    for tc, jc in zip(cb.parity_coords(H, W, parity),
                      jcb.parity_coords(H, W, parity)):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(cb.parity_mask(H, W, parity).numpy(),
                                  np.asarray(jcb.parity_mask(H, W, parity)))
    # Round trip of the packed class.
    back = cb.parity_expand(cb.parity_compress(torch.as_tensor(d), parity),
                            torch.zeros(H, W), parity)
    mask = cb.parity_mask(H, W, parity).numpy()
    np.testing.assert_array_equal(back.numpy()[mask], d[mask])


@pytest.mark.parametrize("dy,dx", [(3, -2), (-5, 0), (0, 7), (-30, 1)])
def test_shifts_exact(field, dy, dx):
    _, d, _ = field
    np.testing.assert_array_equal(
        cb.shift_const(torch.as_tensor(d), dy, dx, np.inf).numpy(),
        np.asarray(jcb.shift_const(jnp.asarray(d), dy, dx, jnp.inf)))
    np.testing.assert_array_equal(
        samp.shift_with_edge_clamp(torch.as_tensor(d), dy, dx).numpy(),
        np.asarray(jsamp.shift_with_edge_clamp(jnp.asarray(d), dy, dx)))


def test_packed_bilinear_sample_matches(field):
    _, d, _ = field
    img = (d * 40 + 128).astype(np.float32)
    rng = np.random.default_rng(9)
    x = rng.uniform(-3, W + 3, (50,)).astype(np.float32)
    y = rng.uniform(-3, H + 3, (50,)).astype(np.float32)
    for dtype, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        t = samp.bilinear_sample_packed(samp.pack_image(torch.as_tensor(img),
                                                        dtype),
                                        torch.as_tensor(x),
                                        torch.as_tensor(y))
        j = jsamp.bilinear_sample_packed(jsamp.pack_image(jnp.asarray(img),
                                                          jdt),
                                         jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-4)
    np.testing.assert_allclose(
        samp.bilinear_sample(torch.as_tensor(img), torch.as_tensor(x),
                             torch.as_tensor(y)).numpy(),
        np.asarray(jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                         jnp.asarray(y))),
        rtol=1e-6, atol=1e-4)
