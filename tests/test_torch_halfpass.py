"""PatchMatch's checkerboard half-pass around the cost kernel: the port's
plain version (tsar_mvs_tpu_torch/ops/halfpass.py, what kernel B6 computes,
in its rounding order) against the JAX package's `_propagation_pass` and
`_refinement_pass` (s-volume sampler, 96x128 and an odd 95x128, 3 views),
against a numpy emulation of the kernels' loops, and kernel B6
(csrc/halfpass.cu, wrapper ops/cuda_halfpass.py) against the plain
version on the card.

Tolerances:
* propagation against JAX: those of tests/test_torch_patchmatch.py's
  test_propagation_pass_matches_jax. Where either cost is below 0.99 the
  costs agree to the B1 spec (median < 5e-4, q99 < 5e-3); the other
  parity is untouched; the winning plane (d and normal) is equal wherever
  the JAX winner beats the runner-up, the stored cost included, by more
  than 1e-3 and the two samplers' costs of every candidate there agree
  within 5e-4 (the spec's median). Where a candidate's cost is off by
  more, the pick follows the sampler and not the half-pass: the spec's
  tail reaches 0.055 at one candidate on the odd scene's last row, and
  near cost 1.0 (NCC near 0) in a low-texture corner of the 96x128 scene
  the samplers differ by up to 0.2 or give NaN against cost_max; the
  port's half-pass from before kernel B6 picks other winners than JAX's
  at the same pixels;
* refinement against JAX, fed JAX's own draws (scale_body's u and the
  [0, 1) draw of its normal step, made from the key here): at pixels
  whose accept is clear at every scale (the proposal's cost and the
  stored one more than 1e-3 apart, the smaller below 0.99, the spec's
  domain, and the two samplers' costs of the proposal within 5e-4, as
  above), the planes within 1e-5 (the normalisation differs in the last
  bit: rsqrt against 1 / sqrt) and the costs to the B1 spec; the other
  parity untouched. Above 0.99 even JAX's own costs of one plane differ
  by up to 0.25 between its jitted pass and an eager call;
* the emulation against the plain version, and the kernel against the
  plain version: exact (int32 views where a value is not NaN; NaN at the
  same places).
"""

import dataclasses

import jax
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
from tsar_mvs_tpu_torch import _build, convert
from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import cuda_halfpass
from tsar_mvs_tpu_torch.ops import halfpass as hp
from tsar_mvs_tpu_torch.ops import ncc
from tsar_mvs_tpu_torch.ops.ncc import MultiviewCost

torch.set_num_threads(2)
f32 = np.float32
SIDES = {"packed": (96, 128), "dense": (95, 128)}


def _state(rng, scene, jc, H, W):
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


def _setup(layout: str) -> dict:
    H, W = SIDES[layout]
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
    assert (t_pctx is None) == (layout == "dense")
    jstate = _state(np.random.default_rng(0), scene, jc, H, W)
    return dict(H=H, W=W, jc=jc, tc=tc, params=params, tparams=tparams,
                jstats=jstats, j=(j_cost_fn, j_pctx), t=(t_cost_fn, t_pctx),
                grid=hp.make_grid(tc, H, W, t_pctx), jstate=jstate,
                tstate=convert.plane_state(jstate, "cpu"))


@pytest.fixture(scope="module")
def setups():
    return {layout: _setup(layout) for layout in SIDES}


def _at_parity(a, H, W, parity):
    """The parity's pixels of a dense (H, W[, 3]) array, flattened."""
    mask = cb.parity_mask(H, W, parity).numpy()
    return np.asarray(a)[mask]


# --- the plain version against the JAX package ------------------------------

@pytest.mark.parametrize("layout,banks,parity",
                         [("packed", 8, 0), ("packed", 4, 1),
                          ("dense", 8, 0)])
def test_propagation_plain_matches_jax(setups, layout, banks, parity):
    """The plain propagation half-pass (on the CPU, `_propagation_pass`
    runs it) against JAX's `_propagation_pass` on the same state: packed
    at 8 and 4 banks (the coarsest and the lifted levels), dense at an
    odd side."""
    s = setups[layout]
    H, W = s["H"], s["W"]
    params = dataclasses.replace(s["params"], prop_banks=banks)
    tparams = dataclasses.replace(s["tparams"], prop_banks=banks)
    j_cost_fn, j_pctx = s["j"]
    t_cost_fn, t_pctx = s["t"]
    n0 = hp.PLAIN_CALLS
    jout = jpm._propagation_pass(s["jstate"], parity, j_cost_fn, s["jc"],
                                 params, None, j_pctx)
    tout = pm._propagation_pass(s["tstate"], parity, t_cost_fn, s["tc"],
                                tparams, t_pctx)
    assert hp.PLAIN_CALLS == n0 + 2

    # JAX's candidate costs on the dense grid, to find the clear winners.
    st = s["jstate"]
    cands = jcb.select_candidates(st.normal, st.d, st.cost)
    cn, cd, cv = (a[-banks:] for a in cands)
    mv = j_cost_fn(cn, cd, None)
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    dep = jgeo.depth_from_plane(s["jc"], cn, cd, xx, yy)
    ok = cv & (dep >= s["jc"].depth_min) & (dep <= s["jc"].depth_max)
    cc = np.asarray(jnp.where(ok, mv.cost, jnp.inf))
    tcands = cb.select_candidates(s["tstate"].normal, s["tstate"].d,
                                  s["tstate"].cost, cb.BANKS[-banks:])
    tcc = np.where(np.asarray(ok), t_cost_fn(tcands.normal, tcands.d,
                                             None).cost.numpy(), np.inf)
    with np.errstate(invalid="ignore"):
        agree = np.all((tcc == cc) | (np.abs(tcc - cc) < 5e-4), axis=0)
    allc = np.concatenate([np.asarray(st.cost)[None], cc])
    srt = np.sort(allc, axis=0)
    clear = _at_parity(((srt[1] - srt[0]) > 1e-3) & agree, H, W, parity)

    def at(a):
        return _at_parity(a, H, W, parity)

    jc_cost, tc_cost = at(jout.cost), at(tout.cost.numpy())
    delta = np.abs(jc_cost - tc_cost)
    sharp = np.minimum(jc_cost, tc_cost) < 0.99
    assert np.quantile(delta[sharp], 0.5) < 5e-4
    assert np.quantile(delta[sharp], 0.99) < 5e-3
    np.testing.assert_array_equal(at(tout.d.numpy())[clear],
                                  at(jout.d)[clear])
    np.testing.assert_array_equal(at(tout.normal.numpy())[clear],
                                  at(jout.normal)[clear])
    assert clear.mean() > 0.75
    # The other parity is untouched, and so is the input state.
    for field in pm.PlaneState._fields:
        np.testing.assert_array_equal(
            _at_parity(getattr(tout, field).numpy(), H, W, 1 - parity),
            _at_parity(getattr(st, field), H, W, 1 - parity))
        np.testing.assert_array_equal(getattr(s["tstate"], field).numpy(),
                                      np.asarray(getattr(st, field)))


def _jax_draws(key, params, shape):
    """scale_body's draws (blocked False) from `key`, as numpy: u of the
    disparity step and the [0, 1) draw r of the normal step, whose
    uniform(-dn, dn) is r * 2dn - dn."""
    out = []
    for k in jax.random.split(key, len(jpm.refine_schedule(params))):
        k_z, k_n = jax.random.split(k)
        out.append((np.array(jax.random.uniform(k_z, shape, jnp.float32)),
                    np.array(jax.random.uniform(k_n, shape + (3,),
                                                jnp.float32))))
    return out


def _clear_refine(s, parity, draws) -> np.ndarray:
    """Dense mask of the parity's pixels whose accept is clear at every
    scale of the plain refinement: |proposal cost - stored cost| > 1e-3,
    the smaller below 0.99, and the JAX sampler's cost of the proposal
    within 5e-4 of the port's."""
    H, W = s["H"], s["W"]
    grid = s["grid"]
    cost_fn, j_cost_fn = s["t"][0], s["j"][0]
    state = pm._own(s["tstate"])
    clear = None
    for (dz, dn), (u, r) in zip(pm.refine_schedule(s["tparams"]), draws):
        prop = hp.refine_propose_plain(state, parity, grid, u, r,
                                       s["tparams"].min_disparity,
                                       s["tparams"].max_disparity, dz, dn)
        mv = cost_fn(prop.normal, prop.d, parity if grid.packed else None,
                     scalars=(prop.s0, prop.sx, prop.sy))
        jmv = j_cost_fn(jnp.asarray(prop.normal.numpy()),
                        jnp.asarray(prop.d.numpy()),
                        parity if grid.packed else None)
        cur = hp._gather(state, parity, grid.packed)
        ok = (((mv.cost - cur.cost).abs() > 1e-3)
              & (torch.minimum(mv.cost, cur.cost) < 0.99)
              & ((mv.cost - torch.as_tensor(np.asarray(jmv.cost))).abs()
                 < 5e-4))
        clear = ok if clear is None else clear & ok
        hp.refine_accept_plain(state, parity, grid, prop, mv)
    if grid.packed:
        clear = cb.parity_expand(clear, torch.zeros((H, W), dtype=torch.bool),
                                 parity)
    return (clear & cb.parity_mask(H, W, parity)).numpy()


@pytest.mark.parametrize("layout,parity", [("packed", 0), ("packed", 1),
                                           ("dense", 1)])
def test_refinement_plain_matches_jax_on_its_draws(setups, layout, parity):
    """The plain refinement half-pass (hp.refinement, which
    `_refinement_pass` and the step run) fed the JAX package's own draws
    against JAX's `_refinement_pass` from the same key."""
    s = setups[layout]
    H, W = s["H"], s["W"]
    j_cost_fn, j_pctx = s["j"]
    key = jax.random.PRNGKey(7 + parity)
    shape = (H, W // 2) if j_pctx is not None else (H, W)
    draws = [(torch.as_tensor(u), torch.as_tensor(r))
             for u, r in _jax_draws(key, s["params"], shape)]
    jout = jpm._refinement_pass(s["jstate"], parity, key, j_cost_fn,
                                s["jstats"].rays, s["jc"], s["params"], None,
                                j_pctx)
    tout = pm._own(s["tstate"])
    hp.refinement(tout, parity, s["grid"], s["t"][0],
                  pm.refine_schedule(s["tparams"]), draws,
                  s["tparams"].min_disparity, s["tparams"].max_disparity)
    clear = _clear_refine(s, parity, draws)
    assert clear.sum() > 0.6 * (H * W // 2)
    np.testing.assert_allclose(tout.d.numpy()[clear],
                               np.asarray(jout.d)[clear], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tout.normal.numpy()[clear],
                               np.asarray(jout.normal)[clear], rtol=1e-5,
                               atol=1e-5)
    delta = np.abs(tout.cost.numpy()[clear] - np.asarray(jout.cost)[clear])
    assert np.quantile(delta, 0.5) < 5e-4
    assert np.quantile(delta, 0.99) < 5e-3
    other = ~cb.parity_mask(H, W, parity).numpy()
    for field in pm.PlaneState._fields:
        np.testing.assert_array_equal(getattr(tout, field).numpy()[other],
                                      np.asarray(getattr(s["jstate"],
                                                         field))[other])


def test_iterate_copies_a_lifted_state(setups):
    """The passes update their state in place; `_iterate` does so on its
    own copy of a lifted state, which the caller keeps as it was."""
    s = setups["packed"]
    init = s["tstate"]
    before = [t.clone() for t in init]
    out = pm._iterate(torch.Generator().manual_seed(0), s["t"][0],
                      s["t"][1], s["grid"].rays[0], s["tc"], s["tparams"],
                      1, init)
    for a, b in zip(init, before):
        assert torch.equal(a, b)
    assert not torch.equal(out.d, init.d)


def test_refinement_pass_draws_from_its_generator(setups):
    """`_refinement_pass` works on a copy and draws each scale's (u, r)
    from its generator just before the scale (hp.draw_refine), as the
    step does: equal to hp.refinement on those draws made ahead."""
    s = setups["packed"]
    init = s["tstate"]
    before = [t.clone() for t in init]
    sched = pm.refine_schedule(s["tparams"])
    out = pm._refinement_pass(init, 1, torch.Generator().manual_seed(5),
                              s["t"][0], s["tc"], s["tparams"], s["t"][1])
    gen = torch.Generator().manual_seed(5)
    draws = [hp.draw_refine(gen, hp.grid_shape(s["grid"], s["H"], s["W"]),
                            "cpu") for _ in sched]
    ref = pm._own(init)
    hp.refinement(ref, 1, s["grid"], s["t"][0], sched, draws,
                  s["tparams"].min_disparity, s["tparams"].max_disparity)
    for a, b in zip(out, ref):
        assert _bits_equal(a.numpy(), b.numpy())
    for a, b in zip(init, before):
        assert torch.equal(a, b)
    assert not torch.equal(out.d, init.d)


def _ref_stats_per_offset(img, params):
    """precompute_ref_stats as the port computed it before kernel B6: one
    shift_with_edge_clamp and weight an offset, stacked."""
    import math
    from tsar_mvs_tpu_torch.ops.sampling import shift_with_edge_clamp
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    shifted, weights = [], []
    for (i, j) in ncc.window_offsets(params):
        ref_c = shift_with_edge_clamp(img, j, i) - img
        shifted.append(ref_c)
        weights.append(torch.exp(-math.sqrt(i * i + j * j) * inv_2ss
                                 - torch.abs(ref_c) * inv_2sc))
    ref_centered, wts = torch.stack(shifted), torch.stack(weights)
    inv_wsum = 1.0 / torch.sum(wts, dim=0)
    mean_ref = torch.sum(wts * ref_centered, dim=0) * inv_wsum
    mean_ref_ref = torch.sum(wts * ref_centered * ref_centered,
                             dim=0) * inv_wsum
    return dict(ref_centered=ref_centered, weights=wts, inv_wsum=inv_wsum,
                mean_ref=mean_ref,
                var_ref=mean_ref_ref - mean_ref * mean_ref)


@pytest.mark.parametrize("H,W", [(48, 64), (50, 67)])
def test_ref_stats_gather_equals_per_offset_loop(H, W):
    """ncc.precompute_ref_stats' one gather over every window offset gives
    the per-offset shift_with_edge_clamp loop's statistics to the bit, at
    an even and an odd size."""
    scene = make_scene(height=H, width=W, num_views=2, seed=2)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    tparams = convert.algorithm_params(AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f)))
    img = torch.as_tensor(scene.images[0])
    got = ncc.precompute_ref_stats(img, convert.camera_set(jc, "cpu"),
                                   tparams)
    for name, want in _ref_stats_per_offset(img, tparams).items():
        assert _bits_equal(getattr(got, name).numpy(), want.numpy()), name


# --- a numpy emulation of the kernels' loops against the plain version ------

def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == bool or a.dtype.kind in "iu":
        return np.array_equal(a, b)
    na, nb = np.isnan(a), np.isnan(b)
    return (np.array_equal(na, nb)
            and np.array_equal(a[~na].view(np.int32),
                               b[~nb].view(np.int32)))


def _xy(H, W, parity, packed):
    Wc = W // 2 if packed else W
    y = np.arange(H)[:, None].repeat(Wc, 1)
    j = np.arange(Wc)[None, :].repeat(H, 0)
    x = 2 * j + (parity + y) % 2 if packed else j
    return y, x


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[
        ..., 2]


def _emu_select(st, parity, banks, grid):
    """prop_select as csrc/halfpass.cu loops it: per bank the samples in
    order, the first initialising, a later one replacing only when
    strictly cheaper, out of bounds +inf with no plane."""
    normal, d, cost = (t.numpy() for t in (st.normal, st.d, st.cost))
    H, W = d.shape
    y, x = _xy(H, W, parity, grid.packed)
    rays = grid.rays[parity].numpy()
    c = grid.consts.numpy()
    outs = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for bank in banks:
            for s, (dx, dy) in enumerate(bank):
                qx, qy = x + dx, y + dy
                inb = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
                q = np.where(inb, qy * W + qx, -1)
                cs = np.where(inb, cost.reshape(-1)[np.maximum(q, 0)],
                              f32(np.inf))
                if s == 0:
                    best_c, best = cs, q
                else:
                    t = cs < best_c
                    best_c, best = np.where(t, cs, best_c), np.where(t, q,
                                                                     best)
            have = best >= 0
            n = np.where(have[..., None],
                         normal.reshape(-1, 3)[np.maximum(best, 0)], f32(0))
            dd = np.where(have, d.reshape(-1)[np.maximum(best, 0)], f32(0))
            inv = f32(1) / dd
            outs.append((n, dd, np.isfinite(best_c), _dot(n, rays) * inv,
                         _dot(n, c[7:10]) * inv, _dot(n, c[10:13]) * inv))
    return [np.stack(a) for a in zip(*outs)]


def _emu_depth(n, d, x, y, c):
    den = (n[..., 0] * (x.astype(f32) - c[2])
           + (n[..., 1] * (y.astype(f32) - c[3])) * c[4]) + n[..., 2] * c[0]
    return ((-d) * c[0]) / den


def _emu_write(out, p, take, vals):
    for name, v in vals.items():
        a = (out[name].reshape(-1, 3) if name == "normal"
             else out[name].reshape(-1))
        a[p[take]] = v[take]


def _state_np(st):
    return {f: getattr(st, f).numpy().copy() for f in pm.PlaneState._fields}


def _emu_prop_accept(st, parity, cands, mv, grid):
    """prop_accept as the kernel loops it: per position the banks in
    order against the running best from the stored cost."""
    out = _state_np(st)
    H, W = out["d"].shape
    y, x = _xy(H, W, parity, grid.packed)
    upd = np.ones_like(y, bool) if grid.packed else (x + y) % 2 == parity
    c = grid.consts.numpy()
    p = y * W + x
    best_c = out["cost"].reshape(-1)[p]
    take = np.full(p.shape, -1)
    cn, cd, cv = (t.numpy() for t in cands[:3])
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(cd.shape[0]):
            depth = _emu_depth(cn[k], cd[k], x, y, c)
            ok = cv[k] & (depth >= c[5]) & (depth <= c[6])
            cc = np.where(ok, mv.cost[k].numpy(), f32(np.inf))
            t = cc < best_c
            best_c, take = np.where(t, cc, best_c), np.where(t, k, take)
    sel = (take >= 0) & upd
    k = np.maximum(take, 0)
    j = np.indices(take.shape)
    _emu_write(out, p, sel, {
        "normal": cn[k, j[0], j[1]], "d": cd[k, j[0], j[1]],
        "cost": best_c, "ratio": mv.ratio.numpy()[k, j[0], j[1]],
        "best_view": mv.best_view.numpy()[k, j[0], j[1]]})
    return out


def _emu_propose(st, parity, grid, u, r, lo_d, hi_d, dz, dn):
    """refine_propose as the kernel computes it, step by step in
    float32."""
    normal, d = st.normal.numpy(), st.d.numpy()
    H, W = d.shape
    y, x = _xy(H, W, parity, grid.packed)
    p = y * W + x
    c = grid.consts.numpy()
    n = normal.reshape(-1, 3)[p]
    u, r = u.numpy(), r.numpy()
    lo_d, hi_d, dz = f32(lo_d), f32(hi_d), f32(dz)
    with np.errstate(divide="ignore", invalid="ignore"):
        fb = c[0] * c[1]
        disp_now = fb / _emu_depth(n, d.reshape(-1)[p], x, y, c)
        lo = disp_now + lo_d
        lo = -np.where(lo > dz, dz, lo)
        hi = hi_d - disp_now
        hi = np.where(hi > dz, dz, hi)
        disp = disp_now + (lo + u * (hi - lo))
        disp = np.where(disp < lo_d, lo_d, disp)
        disp = np.where(disp > hi_d, hi_d, disp)
        depth_new = fb / disp
        v = n + (f32(2.0 * dn) * r + f32(-dn))
        inv = f32(1) / np.sqrt(_dot(v, v) + f32(hp.EPS))
        m = v * inv[..., None]
        m = np.where((_dot(m, grid.vv[parity].numpy()) > 0)[..., None], -m,
                     m)
        nr = _dot(m, grid.rays[parity].numpy())
        d_new = (-depth_new) * nr
        inv_d = f32(1) / d_new
        return m, d_new, nr * inv_d, _dot(m, c[7:10]) * inv_d, _dot(
            m, c[10:13]) * inv_d


def _emu_refine_accept(st, parity, grid, prop, mv):
    out = _state_np(st)
    H, W = out["d"].shape
    y, x = _xy(H, W, parity, grid.packed)
    upd = np.ones_like(y, bool) if grid.packed else (x + y) % 2 == parity
    p = y * W + x
    take = (mv.cost.numpy() < out["cost"].reshape(-1)[p]) & upd
    _emu_write(out, p, take, {"normal": prop.normal.numpy(),
                              "d": prop.d.numpy(), "cost": mv.cost.numpy(),
                              "ratio": mv.ratio.numpy(),
                              "best_view": mv.best_view.numpy()})
    return out


EMU_CASES = ("recorded", "stress", "all_inf")


def _emu_inputs(setups, layout, case, parity, device="cpu"):
    """(state, grid, candidates' MultiviewCost of 8 banks, a proposal's
    MultiviewCost, draws) of one emulation case: the fixture's state, its
    kernel_times.b6_stress (d = 0 planes, NaN d, NaN and +inf costs, tied
    costs, u at 0 and 1 - 2^-24) or +inf costs on a block wider than the
    far banks' reach (banks whose every sample is +inf). The costs come
    from a generator: a third tie the stored cost, some are NaN."""
    s = setups[layout]
    H, W = s["H"], s["W"]
    grid = s["grid"]
    Hc, Wc = hp.grid_shape(grid, H, W)
    rng = np.random.default_rng(3)
    draws = [(torch.as_tensor(rng.random((Hc, Wc), dtype=f32)),
              torch.as_tensor(rng.random((Hc, Wc, 3), dtype=f32)))]
    call = {"kind": "refinement", "state": s["tstate"], "draws": draws}
    if case == "stress":
        call = kt.b6_stress(call)
    state = call["state"]
    if case == "all_inf":
        cost = state.cost.clone()
        cost[20:80, 30:100] = float("inf")
        state = state._replace(cost=cost)
    stored = hp._gather(state, parity, grid.packed).cost.numpy()

    def mvcost(lead):
        c = rng.uniform(0.1, 2.0, lead + (Hc, Wc)).astype(f32)
        c = np.where(rng.random(c.shape) < 0.3, stored, c)
        c = np.where(rng.random(c.shape) < 0.02, f32(np.nan), c)
        return MultiviewCost(
            cost=torch.as_tensor(c),
            best_view=torch.as_tensor(rng.integers(-1, 3, c.shape,
                                                   dtype=np.int32)),
            ratio=torch.as_tensor(rng.random(c.shape, dtype=f32)))
    mv8, mv1 = mvcost((8,)), mvcost(())
    to = (lambda t: t.to(device)) if device != "cpu" else (lambda t: t)
    dev_grid = grid._replace(rays=tuple(map(to, grid.rays)),
                             vv=tuple(map(to, grid.vv)),
                             coords=tuple(tuple(map(to, xy))
                                          for xy in grid.coords),
                             consts=to(grid.consts))
    return (pm.PlaneState(*(to(t).contiguous() for t in state)), dev_grid,
            MultiviewCost(*map(to, mv8)), MultiviewCost(*map(to, mv1)),
            [tuple(map(to, dr)) for dr in call["draws"]])


@pytest.mark.parametrize("case", EMU_CASES)
@pytest.mark.parametrize("layout,parity", [("packed", 0), ("packed", 1),
                                           ("dense", 0)])
def test_emulation_of_kernel_order_equals_plain(setups, layout, parity,
                                                case):
    """Each B6 kernel's loop and rounding order, emulated in numpy
    float32, against the plain version on d = 0 padding, NaN depths,
    all-inf banks and tied costs: every output equal to the bit."""
    state, grid, mv8, mv1, draws = _emu_inputs(setups, layout, case, parity)
    s = setups[layout]
    banks = cb.BANKS
    cands = hp.prop_select_plain(state, parity, banks, grid)
    emu = _emu_select(state, parity, banks, grid)
    for name, a, b in zip(hp.Candidates._fields, emu, cands):
        assert _bits_equal(a, b.numpy()), name
    assert (~cands.valid).any() and torch.isnan(cands.s0).any()

    out = pm._own(state)
    hp.prop_accept_plain(out, parity, cands, mv8, grid)
    emu = _emu_prop_accept(state, parity, cands, mv8, grid)
    for f in pm.PlaneState._fields:
        assert _bits_equal(emu[f], getattr(out, f).numpy()), f

    (dz, dn), (u, r) = pm.refine_schedule(s["tparams"])[0], draws[0]
    args = (state, parity, grid, u, r, s["tparams"].min_disparity,
            s["tparams"].max_disparity, dz, dn)
    prop = hp.refine_propose_plain(*args)
    emu = _emu_propose(*args)
    for name, a, b in zip(hp.Proposal._fields, emu, prop):
        assert _bits_equal(a, b.numpy()), name
    out = pm._own(state)
    hp.refine_accept_plain(out, parity, grid, prop, mv1)
    emu = _emu_refine_accept(state, parity, grid, prop, mv1)
    for f in pm.PlaneState._fields:
        assert _bits_equal(emu[f], getattr(out, f).numpy()), f


# --- the wrapper without a card ---------------------------------------------

def test_cuda_tensor_with_a_failing_launch_raises(setups, monkeypatch):
    """A CUDA tensor goes to the kernel: a launch that returns a CUDA error
    raises and is not counted, and malformed inputs raise before any
    launch. (Tensors pose as CUDA ones and the library is a stand-in.)"""
    class Lib:
        calls = 0

        def __getattr__(self, name):
            def launch(*args):
                Lib.calls += 1
                return 700
            return launch

    s = setups["packed"]
    state, grid = s["tstate"], s["grid"]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "load_library", Lib)
    monkeypatch.setattr(cuda_halfpass, "_check",
                        lambda *a, **k: None)
    before = cuda_halfpass.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        hp.prop_select(state, 0, cb.BANKS, grid)
    assert Lib.calls == 1 and cuda_halfpass.LAUNCHES == before
    monkeypatch.undo()
    monkeypatch.setattr(_build, "load_library", Lib)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_halfpass.prop_select(state.normal, state.d, state.cost, 0,
                                  True, grid.rays[0], grid.consts, cb.BANKS)
    with pytest.raises(ValueError, match="banks"):
        cuda_halfpass.prop_select(state.normal, state.d, state.cost, 0,
                                  True, grid.rays[0], grid.consts, ())
    with pytest.raises(ValueError, match="even sides"):
        cuda_halfpass.refine_accept(setups["dense"]["tstate"], 0, True, None,
                                    None, None)
    assert Lib.calls == 1


# --- kernel B6 on the card ---------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", EMU_CASES)
@pytest.mark.parametrize("layout,parity", [("packed", 0), ("packed", 1),
                                           ("dense", 0)])
def test_b6_kernels_match_plain_on_card(setups, layout, parity, case):
    """Each B6 kernel against its plain version on the card on the
    emulation test's inputs: every output equal (NaN at the same places),
    one launch a kernel. Needs an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    state, grid, mv8, mv1, draws = _emu_inputs(setups, layout, case, parity,
                                               dev)
    s = setups[layout]
    n0 = cuda_halfpass.LAUNCHES
    mk = hp.prop_select(state, parity, cb.BANKS, grid)
    mp = hp.prop_select_plain(state, parity, cb.BANKS, grid)
    assert kt.b6_agreement(mk, mp)["max_abs_err"] == 0
    assert kt.b6_agreement(mk, mp)["mismatches"] == 0
    sk, sp = pm._own(state), pm._own(state)
    hp.prop_accept(sk, parity, mp, mv8, grid)
    hp.prop_accept_plain(sp, parity, mp, mv8, grid)
    agree = kt.b6_agreement(sk, sp)
    assert agree["max_abs_err"] == 0 and agree["mismatches"] == 0, agree
    (dz, dn), (u, r) = pm.refine_schedule(s["tparams"])[0], draws[0]
    args = (state, parity, grid, u, r, s["tparams"].min_disparity,
            s["tparams"].max_disparity, dz, dn)
    pk, pp = hp.refine_propose(*args), hp.refine_propose_plain(*args)
    assert kt.b6_agreement(pk, pp)["max_abs_err"] == 0
    sk, sp = pm._own(state), pm._own(state)
    hp.refine_accept(sk, parity, grid, pp, mv1)
    hp.refine_accept_plain(sp, parity, grid, pp, mv1)
    torch.cuda.synchronize()
    agree = kt.b6_agreement(sk, sp)
    assert agree["max_abs_err"] == 0 and agree["mismatches"] == 0, agree
    assert cuda_halfpass.LAUNCHES == n0 + 4
