"""Region RANSAC: the port's plain version
(tsar_mvs_tpu_torch/models/ransac.py, every region of a view in one call,
its draws made up front) against the JAX package, against a numpy
emulation of kernel B5's operation order, and kernel B5 (csrc/ransac.cu,
wrapper ops/cuda_ransac.py) against the plain version on the card.

Tolerances:
* `ransac_regions_plain` against the JAX `ransac_plane` (without its
  polish): inlier counts within 2% and thresholds within rel 1e-5 per
  region, the bounds of tests/test_torch_tsar.py: the two packages draw
  different random numbers;
* `_plane_from_triplet` and `_residual` against JAX's
  `_plane_from_triplet` and `_count_inliers`: atol 1e-6 (the cross product and
  the norm sum in other orders; JAX's normalisation may differ in the
  last bit); degenerate triplets give d = inf in both. Inlier counts
  equal, except for points whose residual lies within 1e-6 of the
  threshold: JAX's matrix product rounds differently;
* the emulation of the kernel's order, a batch against its regions one
  at a time, and the kernel itself against the plain version: exact
  (int32 views of planes and thresholds, counts equal).
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu.models import ransac as jransac
from tsar_mvs_tpu_torch import _build
from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models import ransac, tsar
from tsar_mvs_tpu_torch.ops import cuda_ransac
from tsar_mvs_tpu_torch import trace

torch.set_num_threads(2)
SOURCE = Path(cuda_ransac.__file__).resolve().parents[1] / "csrc" / \
    "ransac.cu"
# The stress inputs cut to test size: the large plane's points, rounds of
# 1000 hypotheses, annealing rounds and the points of "big".
CUT = dict(n_big=3000, rounds=2, anneal_rounds=40, n_over=4000)
F = np.float32


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _assert_equal_fits(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float32:
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_array_equal(a, b)


def _plane_regions(sizes, seed, noise=0.002, outliers=0.1):
    """Regions of points on slanted planes in front of a camera (depth
    2-5), relative depth noise and a share of outliers."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n in enumerate(sizes):
        xy = rng.uniform(-0.5, 0.5, (n, 2))
        z = 3.0 + k * 0.5 + 0.3 * xy[:, 0] - 0.2 * xy[:, 1]
        z *= 1.0 + noise * rng.standard_normal(n)
        bad = rng.random(n) < outliers
        z[bad] *= rng.uniform(0.7, 1.3, int(bad.sum()))
        out.append(np.column_stack([xy * z[:, None], z]).astype(np.float32))
    return out


KW = dict(iters=2000, anneal_rounds=200, thr_max=0.05, thr_step=0.002)
THR_BASE = 0.005


def test_plain_matches_jax_on_three_regions():
    """Three regions of different sizes in one batched call of the plain
    version against three calls of the JAX ransac_plane (no polish)."""
    regions = _plane_regions((150, 600, 1400), seed=3)
    gen = torch.Generator().manual_seed(5)
    draws = [ransac.draw_region(gen, len(p), KW["iters"],
                                KW["anneal_rounds"]) for p in regions]
    thr0 = [ransac.initial_threshold(len(p), THR_BASE) for p in regions]
    inp = ransac.pack_regions([torch.as_tensor(p) for p in regions],
                              [d[0] for d in draws], [d[1] for d in draws],
                              thr0, KW["thr_max"], KW["thr_step"])
    plane, count, thr = ransac.ransac_regions(inp)
    assert plane.shape == (3, 4) and count.dtype == torch.int32
    for r, p in enumerate(regions):
        pad = np.zeros((2048 - len(p), 3), np.float32)
        jfit = jransac.ransac_plane(
            jax.random.PRNGKey(r), jnp.asarray(np.concatenate([p, pad])),
            jnp.asarray(np.arange(2048) < len(p)), thr0[r],
            lsq_polish=False, **KW)
        ji, ti = int(jfit.inliers), int(count[r])
        assert abs(ti - ji) <= 0.02 * ji, (r, ti, ji)
        assert float(thr[r]) == pytest.approx(float(jfit.threshold),
                                              rel=1e-5)
        assert ti > 0.6 * len(p)


def test_triplet_planes_and_counts_match_jax():
    rng = np.random.default_rng(4)
    p = rng.uniform(-1.0, 1.0, (3, 300, 3)).astype(np.float32)
    p[1, :20] = p[0, :20]                           # repeated points
    # Collinear with exact differences: multiples of 2^-8 and of 2^-6.
    p[0, 20:50] = np.round(p[0, 20:50] * 256.0) / 256.0
    v = np.float32(2 ** -6) * np.array([1.0, 2.0, 3.0], np.float32)
    p[1, 20:50] = p[0, 20:50] + v
    p[2, 20:50] = p[0, 20:50] + 2 * v
    tp = ransac._plane_from_triplet(*(torch.as_tensor(q) for q in p))
    jp = np.asarray(jransac._plane_from_triplet(*(jnp.asarray(q)
                                                  for q in p)))
    tp = tp.numpy()
    inf_t, inf_j = np.isinf(tp[:, 3]), np.isinf(jp[:, 3])
    np.testing.assert_array_equal(inf_t, inf_j)
    assert inf_t[:50].all() and not inf_t[50:].any()
    np.testing.assert_allclose(tp[~inf_t], jp[~inf_j], atol=1e-6)

    points = rng.uniform(-1.0, 1.0, (2000, 3)).astype(np.float32)
    thr = np.float32(0.05)
    x, y, z = torch.as_tensor(points).unbind(-1)
    tc = (ransac._residual(x, y, z, torch.as_tensor(tp)[:, None])
          < float(thr)).sum(-1).numpy()
    jc = np.asarray(jransac._count_inliers(
        jnp.asarray(points), jnp.ones(2000, jnp.float32), jnp.asarray(tp),
        thr))
    resid = np.abs(points @ tp[:, :3].astype(np.float64).T
                   + tp[None, :, 3].astype(np.float64))
    near = (np.abs(resid - thr) < 1e-6).sum(0)
    assert (np.abs(tc - jc) <= near).all()
    assert (tc[inf_t] == 0).all() and tc[~inf_t].max() > 0


# --- numpy emulation of kernel B5's order ---------------------------------

def _emulated_plane(p1, p2, p3):
    """A hypothesis's plane (csrc/ransac.cu plane_from_triplet), vectorised
    over the hypotheses; every step a float32 operation of its own."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        e = (p2 - p1).astype(F)
        g = (p3 - p1).astype(F)
        nx = F(e[:, 1] * g[:, 2]) - F(e[:, 2] * g[:, 1])
        ny = F(e[:, 2] * g[:, 0]) - F(e[:, 0] * g[:, 2])
        nz = F(e[:, 0] * g[:, 1]) - F(e[:, 1] * g[:, 0])
        norm = np.sqrt((nx * nx + ny * ny) + nz * nz)
        ok = norm > F(ransac.TINY)
        m = np.fmax(norm, F(ransac.EPS))
        n = [np.where(ok, v / m, F(0.0)) for v in (nx, ny, nz)]
        d = -((n[0] * p1[:, 0] + n[1] * p1[:, 1]) + n[2] * p1[:, 2])
    return np.stack(n + [np.where(ok, d, F(np.inf))], -1).astype(F)


def _emulated_count(P, pl, thr) -> np.ndarray:
    """Counts of planes pl (B, 4) over P (N, 3) at thr, an integer sum
    (its order is immaterial) over tiles of 2048 points."""
    out = np.zeros(len(pl), np.int64)
    for s in range(0, len(P), 2048):
        q = P[s:s + 2048]
        with np.errstate(invalid="ignore", over="ignore"):
            r = np.abs(((q[None, :, 0] * pl[:, None, 0]
                         + q[None, :, 1] * pl[:, None, 1])
                        + q[None, :, 2] * pl[:, None, 2]) + pl[:, None, 3])
        out += (r < thr).sum(1)
    return out


def _emulated_candidate(base, dl):
    """An annealing candidate (csrc/ransac.cu candidate): base + dl over
    sqrt(((a a + b b) + c c) + eps), each step rounded to float32."""
    cand = (base + dl).astype(F)
    nrm = np.sqrt(F(F(F(cand[0] * cand[0]) + F(cand[1] * cand[1]))
                    + F(cand[2] * cand[2])) + F(ransac.EPS))
    with np.errstate(invalid="ignore", divide="ignore"):
        return (cand / nrm).astype(F)


def _emulated_tree(p, dl, s: int, steps: int, lookahead: int):
    """The 2^L - 1 candidates of the pass starting at step s from plane p
    (the kernel's lanes): node (level j, accept mask m of the j steps
    before) is 2^j - 1 + m, built with step s + j's perturbation (the last
    step's past the end) from p (m = 0) or from the candidate of the last
    accepted step."""
    nodes = np.zeros(((1 << lookahead) - 1, 4), F)
    for node in range(len(nodes)):
        lev = (node + 1).bit_length() - 1
        msk = node + 1 - (1 << lev)
        hi = msk.bit_length() - 1
        base = nodes[(1 << hi) - 1 + (msk & ((1 << hi) - 1))] if msk else p
        nodes[node] = _emulated_candidate(base, dl[min(s + lev, steps - 1)])
    return nodes


def emulate_b5(inp: ransac.RansacInputs, sms: int = 132,
               cluster: int = cuda_ransac.CLUSTER,
               lookahead: int = cuda_ransac.LOOKAHEAD):
    """Kernel B5 in numpy float32, in its order. Each round: every
    region's 1000 planes, the partial counts of each chunk of the work
    plan (cuda_ransac.round_chunks, on `sms` SMs) added up, then per
    region the decide step: the argmax of the 32-bit keys (count + 1) <<
    10 | (1023 - h), the >= accept, the threshold rule with its probe.
    Then the annealing per unit of cuda_ransac.anneal_units (`cluster`
    blocks a cluster), `lookahead` steps a pass: the tree's 2^L - 1
    candidates, each block's partial counts over its slice of the region
    added up, and the pass's accepts resolved in order."""
    pts = inp.points.numpy()
    off = inp.offsets.tolist()
    n = np.diff(off)
    idx, deltas = inp.idx.numpy(), inp.deltas.numpy()
    R, rounds = idx.shape[:2]
    steps = 4 * deltas.shape[1]
    thr_max, thr_step = F(inp.thr_max), F(inp.thr_step)
    planes = np.tile(np.array([0.0, 0.0, 1.0, -1.0], F), (R, 1))
    counts = np.zeros(R, np.int64)
    thrs = inp.thr0.numpy().astype(F)

    def region(r):
        return pts[off[r]:off[r + 1]]
    for k in range(rounds):
        hp = [_emulated_plane(*(region(r)[idx[r, k, :, i]]
                                for i in range(3))) for r in range(R)]
        c = np.zeros((R, len(hp[0])), np.int64)
        for r, s, e in cuda_ransac.round_chunks(n, sms):
            while s < e:
                end = min(e, off[r + 1])
                c[r] += _emulated_count(pts[s:end], hp[r], thrs[r])
                s, r = end, r + 1
        for r in range(R):
            key = ((c[r] + 1) << 10) | (1023 - np.arange(len(c[r])))
            best = int(key.max())
            bi, bc = 1023 - (best & 1023), (best >> 10) - 1
            if bc >= counts[r]:
                planes[r], counts[r] = hp[r][bi], bc
            grow_small = (F(counts[r]) / F(inp.total[r]) < F(ransac.RATIO)
                          and thrs[r] < thr_max)
            t2 = F(thrs[r] + thr_step)
            count2 = int(_emulated_count(region(r), planes[r][None], t2)[0])
            grow_big = (not grow_small) and \
                F(count2) > F(F(counts[r]) + F(inp.gain[r]))
            if grow_small or grow_big:
                thrs[r] = t2
            if grow_big:
                counts[r] = count2
    units, _ = cuda_ransac.anneal_units(n, cluster)
    for r, nb in dict.fromkeys(u for u in units if u[0] >= 0):
        P = region(r)
        S = -(-len(P) // nb)
        dl = deltas[r].reshape(steps, 4)
        p, count = planes[r].copy(), int(counts[r])
        for s in range(0, steps, lookahead):
            nodes = _emulated_tree(p, dl, s, steps, lookahead)
            tot = sum(_emulated_count(P[q * S:(q + 1) * S], nodes, thrs[r])
                      for q in range(nb))
            mask, sel = 0, -1
            for j in range(min(lookahead, steps - s)):
                nd = (1 << j) - 1 + mask
                if tot[nd] >= count:
                    count, sel, mask = int(tot[nd]), nd, mask | 1 << j
            if sel >= 0:
                p = nodes[sel].copy()
        planes[r], counts[r] = p, count
    return planes, counts.astype(np.int32), thrs


@pytest.fixture(scope="module")
def cases():
    return kt.ransac_cases(dev="cpu", **CUT)


@pytest.mark.parametrize("case", kt.RANSAC_CASES + kt.RANSAC_ALONE)
def test_kernel_order_emulation_equals_plain(cases, case):
    """The numpy emulation of B5's order equals the plain version to the
    bit on each stress input of chip_smoke.py phase 5(c), cut in size."""
    inp = kt.pack_cases(cases, [case])
    _assert_equal_fits(emulate_b5(inp), ransac.ransac_regions_plain(inp))


@pytest.fixture(scope="module")
def design_packs(cases):
    packs = {"three, plane": kt.pack_cases(cases, ["three", "plane"]),
             "odd_steps": kt.pack_cases(cases, ["odd_steps"])}
    return {k: (p, ransac.ransac_regions_plain(p)) for k, p in packs.items()}


@pytest.mark.parametrize("pack", ["three, plane", "odd_steps"])
@pytest.mark.parametrize("cluster,lookahead", list(itertools.product(
    kt.B5_DESIGN["CLUSTER"], kt.B5_DESIGN["LOOKAHEAD"])))
def test_every_design_emulation_equals_plain(design_packs, cluster,
                                             lookahead, pack):
    """Every pair of blocks a cluster and steps a pass that `kernel_times
    b5-design` builds gives the plain version's bits, on 4 SMs' chunks: a
    3-point region (one block) beside one large enough for a whole
    cluster, and "odd_steps" (a part pass at the end for LOOKAHEAD 3)."""
    inp, want = design_packs[pack]
    if pack != "odd_steps":
        assert max(kt.region_sizes(inp)) > cuda_ransac.CLUSTER_MIN_POINTS
    _assert_equal_fits(emulate_b5(inp, 4, cluster, lookahead), want)


def test_kernel_order_emulation_equals_plain_on_a_view_batch():
    """The emulation against the plain version on one batch of three
    regions like a view's (slanted planes with noise and outliers), with
    tied points and one non-finite point added."""
    regions = _plane_regions((90, 400, 1000), seed=8)
    regions[1][:30] = regions[1][0]
    regions[2][5, 2] = np.inf
    gen = torch.Generator().manual_seed(9)
    draws = [ransac.draw_region(gen, len(p), 2000, 30) for p in regions]
    inp = ransac.pack_regions([torch.as_tensor(p) for p in regions],
                              [d[0] for d in draws], [d[1] for d in draws],
                              [ransac.initial_threshold(len(p), THR_BASE)
                               for p in regions], 0.05, 0.002)
    _assert_equal_fits(emulate_b5(inp), ransac.ransac_regions_plain(inp))


def test_stress_cases_do_what_they_say(cases):
    """Each stress input reaches the state it is named for."""
    fits = {c: ransac.ransac_regions_plain(kt.pack_cases(cases, [c]))
            for c in kt.RANSAC_CASES}
    for c in ("equal", "collinear"):
        plane, count, _ = fits[c]
        assert int(count[0]) == 0 and np.isinf(float(plane[0, 3]))
    assert int(fits["three"][1][0]) == 3
    assert int(fits["inf"][1][0]) == 499
    assert float(fits["thr_max"][2][0]) >= 0.003
    assert int(fits["plane"][1][0]) >= 0.65 * CUT["n_big"]
    inp = kt.pack_cases(cases, ["ties"])
    hp = _emulated_plane(*(inp.points.numpy()[inp.idx[0, 0, :, i].numpy()]
                           for i in range(3)))
    c = _emulated_count(inp.points.numpy(), hp, F(inp.thr0[0]))
    assert (c == c.max()).sum() > 1
    # Dozens of small regions beside large ones: one-block units and
    # whole-cluster units in one launch; most points of each fitted.
    n = kt.region_sizes(kt.pack_cases(cases, ["many"]))
    assert len(n) == 42 and min(n) == 3 and max(n[:40]) == 2000
    assert n[40:] == [CUT["n_big"] // 2,
                      2 * cuda_ransac.CLUSTER_MIN_POINTS + 1]
    units = set(cuda_ransac.anneal_units(n)[0])
    assert (41, cuda_ransac.CLUSTER) in units and (0, 1) in units
    fit = fits["many"][1].numpy()
    assert (fit[np.array(n) >= 50] >= 0.6 * np.array(n)[np.array(n) >= 50]
            ).all()
    assert int(fits["big"][1][0]) >= 0.65 * CUT["n_over"]
    # "big" at its default size does not fit a cluster's shared memory.
    assert cuda_ransac.anneal_units(
        [cuda_ransac.CLUSTER * cuda_ransac.SMEM_POINTS + 1])[1] == 0
    # "odd_steps" has annealing rounds of its own, and ends on a part pass
    # at another remainder than the rest wherever LOOKAHEAD allows one (a
    # LOOKAHEAD that divides 4 never leaves one: 4 steps a round).
    odd = cases["odd_steps"][0][2].shape[0]
    assert odd == kt.odd_anneal_rounds(CUT["anneal_rounds"]) != \
        CUT["anneal_rounds"]
    for L in kt.B5_DESIGN["LOOKAHEAD"]:
        if 4 % L:
            assert 4 * odd % L not in (0, 4 * CUT["anneal_rounds"] % L)
    fit = ransac.ransac_regions_plain(kt.pack_cases(cases, ["odd_steps"]))
    assert int(fit[1][0]) >= 0.65 * 2000


def test_batch_equals_one_region_at_a_time(cases):
    """R regions in one call equal R calls of one region, bit for bit."""
    batch = ransac.ransac_regions_plain(kt.pack_cases(cases,
                                                      kt.RANSAC_CASES))
    r = 0
    for c in kt.RANSAC_CASES:
        for reg in cases[c]:
            one = ransac.ransac_regions_plain(kt.pack_cases({c: [reg]},
                                                            [c]))
            _assert_equal_fits([t[r:r + 1] for t in batch], one)
            r += 1
    assert r == batch[0].shape[0]


def test_ransac_plane_is_one_region_of_fit_regions():
    p = torch.as_tensor(_plane_regions((500,), seed=1)[0])
    fit = ransac.ransac_plane(torch.Generator().manual_seed(2), p, 0.01,
                              **KW)
    gen = torch.Generator().manual_seed(2)
    idx, deltas = ransac.draw_region(gen, 500, KW["iters"],
                                     KW["anneal_rounds"])
    want = ransac.fit_regions(ransac.pack_regions(
        [p], [idx], [deltas], [0.01], KW["thr_max"], KW["thr_step"]))
    _assert_equal_fits(fit, [t[0] for t in want])
    assert fit.plane.shape == (4,) and fit.inliers.dtype == torch.int32
    assert float(torch.linalg.norm(fit.plane[:3])) == pytest.approx(1.0)


def test_draws_shapes_and_perturbation_scales():
    gen = torch.Generator().manual_seed(0)
    idx, deltas = ransac.draw_region(gen, 7, 10000, 1000)
    assert idx.shape == (10, 1000, 3) and idx.dtype == torch.int32
    assert int(idx.min()) == 0 and int(idx.max()) == 6
    assert deltas.shape == (1000, 4, 4) and deltas.dtype == torch.float32
    bound = torch.tensor(ransac.SCALES)[:, None] / 2 * \
        torch.tensor(ransac.UNIT)[None, :]
    assert (deltas.abs() <= bound * (1 + 1e-6)).all()
    assert (deltas.abs().amax(0) > 0.9 * bound).all()


def test_pack_regions_rounds_constants_once():
    p = [torch.zeros(5, 3), torch.ones(50001, 3)]
    gen = torch.Generator().manual_seed(0)
    d = [ransac.draw_region(gen, len(q), 1000, 2) for q in p]
    inp = ransac.pack_regions(p, [x[0] for x in d], [x[1] for x in d],
                              [0.1, 0.2], 0.003, 0.0001)
    assert inp.offsets.tolist() == [0, 5, 50006]
    assert inp.total.tolist() == [5.0, 50001.0]
    assert inp.gain.dtype == torch.float32
    assert float(inp.gain[1]) == float(np.float32(0.02 * 50001))
    assert inp.thr_max == float(np.float32(0.003))
    assert inp.thr_step == float(np.float32(0.0001))
    assert ransac.RATIO == float(np.float32(0.3))


def test_fit_region_planes_fits_a_view_in_one_call(monkeypatch):
    """fit_region_planes calls ransac_regions once for all regions of a
    view with 3 or more reliable points, and not at all (counting the
    view) when it has none."""
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.models.weak_texture import WeakTexture
    H, W = 24, 32
    labels = np.zeros((H, W), np.int32)
    labels[:, 10:20] = 1
    labels[:, 20:] = 2
    labels[0, 0] = 3
    weak = WeakTexture(labels_full=labels, labels_small=labels[::4, ::4],
                       text=np.array([1, -1, -1, -1], np.int8),
                       cenx=np.zeros(4), ceny=np.zeros(4),
                       size=np.array([10, 24, 24, 1], np.int32),
                       counts=np.zeros(4, np.int64))
    calls = []
    inner = ransac.ransac_regions

    def spy(inp):
        calls.append(kt.region_sizes(inp))
        return inner(inp)
    monkeypatch.setattr(ransac, "ransac_regions", spy)
    K = np.array([[50.0, 0, 16], [0, 50.0, 12], [0, 0, 1]])
    cams = geo.build_camera_set(
        [K @ np.eye(3, 4), K @ np.hstack([np.eye(3), [[-0.1], [0], [0]]])],
        depth_min=1.0, depth_max=10.0, device="cpu")
    disp = torch.full((H, W), 20.0)
    params = AlgorithmParams(ransac_iters=1000, ransac_anneal_rounds=3,
                             ransac_max_points=200)
    reliable = np.ones((H, W), bool)
    before = trace.counter("ransac.views_without_regions")
    planes = tsar.fit_region_planes(torch.Generator().manual_seed(0),
                                    weak, disp, reliable, cams, params)
    assert calls == [[200, 200]]
    assert (planes[0] == 0).all() and (planes[3] == 0).all()
    assert (planes[1] != 0).any() and (planes[2] != 0).any()
    assert trace.counter("ransac.views_without_regions") == before
    tsar.fit_region_planes(torch.Generator().manual_seed(0), weak, disp,
                           np.zeros((H, W), bool), cams, params)
    assert len(calls) == 1
    assert trace.counter("ransac.views_without_regions") == before + 1


def test_b5_bound_counts_the_function():
    """Two regions of 50,000 points, 10 rounds and 1,000 annealing
    rounds: 14,010 residuals of 8 operations a point and region, the
    hypotheses' planes and the candidates: 11.2 GFLOP, 0.167 ms at
    67 TFLOP/s, 0.335 ms at half that; the bytes take 0.0005 ms."""
    assert kt.b5_flops([50000, 50000], 10, 1000) == \
        2 * (14010 * 50000 * 8 + 10000 * 30 + 4000 * 15)
    b = kt.b5_bound([50000, 50000], 10, 1000)
    assert b["bound_by"] == "operations"
    assert 0.167 < b["bound_ms"] < 0.168
    assert b["ceiling_ms"] == pytest.approx(2 * b["operations_ms"])
    assert b["bytes_ms"] < 0.001


def test_python_mirror_reads_the_kernel_constants():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("HYPOTHESES") == cuda_ransac.HYPOTHESES == \
        ransac.RANSAC_ROUND == kt.RANSAC_HYPOTHESES == 1000
    assert const("THREADS") == cuda_ransac.THREADS
    assert cuda_ransac.THREADS >= cuda_ransac.HYPOTHESES
    # The work plans' constants: the rounds' chunks, the annealing's
    # cluster, lookahead, shared-memory slice and smallest cluster region.
    for name in ("CHUNK_MIN", "CHUNK_BLOCKS_PER_SM", "CLUSTER", "LOOKAHEAD",
                 "SMEM_POINTS", "CLUSTER_MIN_POINTS"):
        assert const(name) == getattr(cuda_ransac, name), name
    assert const("ROUND_THREADS") * const("PER_THREAD") >= \
        cuda_ransac.HYPOTHESES
    assert const("CLUSTER") <= 16 and (1 << const("LOOKAHEAD")) - 1 <= 32
    # A slice and the block's own buffers fit 227 KB of shared memory.
    assert cuda_ransac.SMEM_POINTS * 16 + 4096 <= 232448
    assert cuda_ransac.CLUSTER in kt.B5_DESIGN["CLUSTER"]
    assert cuda_ransac.LOOKAHEAD in kt.B5_DESIGN["LOOKAHEAD"]
    assert const("ANNEAL_THREADS") in kt.B5_DESIGN["ANNEAL_THREADS"]
    # The argmax key: (count + 1) << 10 must fit 32 bits.
    assert (cuda_ransac.MAX_POINTS + 1) << 10 <= 1 << 32
    assert "tsar_ransac_regions" in _build.SIGNATURES
    assert "tsar_ransac_cluster" in _build.SIGNATURES


# Region sizes of views the work plans must serve: the main path's two
# subsampled regions, hundreds of 3-point regions, the "many" mix, one
# region above a cluster's shared memory and a lone triangle.
PLANS = {"main path": [50000, 50000],
         "tiny regions": [3] * 300 + [2000] * 10,
         "many": [3, 2000, 17, 250, 999, 41, 1500, 25000, 4097],
         "above a cluster": [cuda_ransac.CLUSTER * cuda_ransac.SMEM_POINTS
                             + 1, 100],
         "three": [3]}


@pytest.mark.parametrize("name", PLANS)
def test_round_chunks_cover_every_point_once(name):
    """Every point of every region lies in exactly one chunk of the
    rounds' plan; a chunk is a piece of one region or a run of whole
    regions, never larger than the plan's size; the main path fills the
    card with 2-4 blocks an SM, and small regions share blocks."""
    n = PLANS[name]
    sms = 132
    off = np.concatenate([[0], np.cumsum(n)])
    size = max(cuda_ransac.CHUNK_MIN, -(-int(off[-1]) //
                                        (cuda_ransac.CHUNK_BLOCKS_PER_SM
                                         * sms)))
    chunks = cuda_ransac.round_chunks(n, sms)
    seen = np.zeros(int(off[-1]), np.int64)
    for r, s, e in chunks:
        assert off[r] <= s < off[r + 1] and s < e and e - s <= size
        inside = [q for q in range(len(n)) if off[q] < e and off[q + 1] > s]
        assert inside[0] == r
        if len(inside) > 1:        # a run of whole regions
            assert off[r] == s and off[inside[-1] + 1] == e
        seen[s:e] += 1
    assert (seen == 1).all()
    if name == "main path":
        assert 2 * sms <= len(chunks) <= 4 * sms
    if name == "tiny regions":             # 900 points in 4 blocks
        assert sum(r < 300 for r, _, _ in chunks) == -(-900 // size)


@pytest.mark.parametrize("name", PLANS)
def test_anneal_units_cover_every_region_once(name):
    """The annealing's plan: whole clusters of CLUSTER blocks; a region
    above CLUSTER_MIN_POINTS takes one cluster, its ranks' slices
    covering its points once; the others one block each; the shared
    memory holds every slice of at most SMEM_POINTS points."""
    n = PLANS[name]
    C = cuda_ransac.CLUSTER
    units, smem = cuda_ransac.anneal_units(n)
    assert len(units) % C == 0
    regions = []
    for i in range(0, len(units), C):
        group = units[i:i + C]
        if group[0][1] == C:
            r = group[0][0]
            assert group == [(r, C)] * C
            assert n[r] > cuda_ransac.CLUSTER_MIN_POINTS
            S = -(-n[r] // C)
            assert sum(max(0, min(n[r], (q + 1) * S) - q * S)
                       for q in range(C)) == n[r]
            regions.append(r)
        else:
            assert all(nb == 1 for _, nb in group)
            regions += [r for r, _ in group if r >= 0]
            assert all(n[r] <= cuda_ransac.CLUSTER_MIN_POINTS
                       for r, _ in group if r >= 0)
    assert sorted(regions) == list(range(len(n)))
    slices = [-(-n[r] // nb) for r, nb in units if r >= 0]
    assert smem <= cuda_ransac.SMEM_POINTS
    assert all(s <= smem for s in slices if s <= cuda_ransac.SMEM_POINTS)


def test_cpu_tensors_never_reach_the_build(cases, monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(_build, "load_library", refuse)
    before = trace.counter("launches.b5")
    inp = kt.pack_cases(cases, ["ties", "three"])
    _assert_equal_fits(ransac.ransac_regions(inp),
                       ransac.ransac_regions_plain(inp))
    assert trace.counter("launches.b5") == before


def test_cuda_tensor_with_a_failing_launch_raises(cases, monkeypatch):
    """A CUDA tensor goes to the kernel: a launch that returns a CUDA error
    raises and is not counted, and malformed inputs raise before any
    launch. (Tensors pose as CUDA ones and the library is a stand-in.)"""
    class Lib:
        calls = 0
        plans = []

        def tsar_ransac_cluster(self):
            return cuda_ransac.CLUSTER

        def tsar_ransac_regions(self, *args):
            Lib.calls += 1
            Lib.plans.append((args[16], args[18], args[19]))
            return 700

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: type("P", (), {
                            "multi_processor_count": 132}))
    monkeypatch.setattr(_build, "load_library", Lib)
    inp = kt.pack_cases(cases, ["ties", "three"])
    before = trace.counter("launches.b5")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ransac.ransac_regions(inp)
    assert Lib.calls == 1 and trace.counter("launches.b5") == before
    # The plans' sizes: one chunk for both regions, one cluster of
    # one-block units, a slice of 12 points.
    assert Lib.plans == [(1, cuda_ransac.CLUSTER, 12)]
    for bad in (inp._replace(points=inp.points.double()),
                inp._replace(idx=inp.idx.long()),
                inp._replace(idx=inp.idx + 12),
                inp._replace(offsets=torch.tensor([0, 2, 15])),
                inp._replace(thr0=inp.thr0[:1])):
        with pytest.raises((TypeError, ValueError)):
            ransac.ransac_regions(bad)
    assert Lib.calls == 1


# --- kernel B5 on the card --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("names", kt.case_packs())
def test_b5_kernel_matches_plain_on_card(names):
    """Kernel B5 against its plain version on the card on the stress
    inputs (each alone, RANSAC_CASES all in one call, and "odd_steps")
    at the main path's rounds and annealing rounds: one counted call,
    planes and thresholds equal on their int32 views, counts equal.
    Needs an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = kt.ransac_cases(20000, 10, 1000, torch.device("cuda"))
    inp = kt.pack_cases(cases, names)
    before = trace.counter("launches.b5")
    mk = ransac.ransac_regions(inp)
    mp = ransac.ransac_regions_plain(inp)
    torch.cuda.synchronize()
    assert trace.counter("launches.b5") == before + 1
    agree = kt.b5_agreement(mk, mp)
    assert agree["max_abs_err"] == 0, agree
