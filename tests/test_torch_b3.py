"""Kernel B3's design held on the CPU (tsar_mvs_tpu_torch/csrc/direct.cu,
wrapper ops/cuda_direct.py), without the card and without a JAX run:

- the colour record the kernel reads holds the three per-channel
  PackedImages' bf16 values bit for bit, 32-byte aligned;
- the per-(view, offset) term table equals the f32 terms
  `ncc.direct_cost` evaluates, bit for bit;
- the view groups cover every view once, in order, within the kernel's
  register budget, and the Python mirror of the kernel's constants reads
  the same numbers as the source;
- an emulation of the kernel's loop order (offsets outer, the views of a
  group inner, the epilogue and aggregation after each group in view
  order, floor and integer from one rounded-down add, the records and
  the table as the kernel reads them) equals
  `cuda_direct.multiview_cost_direct_plain` bit for bit.

Tolerance: none. The kernel rounds every step in the plain version's
order, so equality is exact; a NaN ratio (0 / 0 where both costs are 0)
agrees with a NaN."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.kernel_times import color_from_gray
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import cuda_direct, ncc
from tsar_mvs_tpu_torch.ops import ncc_color as nc
from tsar_mvs_tpu_torch.ops.ncc import MAXCOST, MultiviewCost
from tsar_mvs_tpu_torch.utils.synthetic import make_scene

torch.set_num_threads(2)
H, W, VIEWS = 32, 48, 10
SOURCE = (Path(cuda_direct.__file__).resolve().parents[1] / "csrc"
          / "direct.cu")


@pytest.fixture(scope="module")
def scene():
    sc = make_scene(height=H, width=W, num_views=VIEWS, seed=5)
    cams = geo.build_camera_set(list(sc.P), depth_min=sc.depth_min,
                                depth_max=sc.depth_max, device="cpu")
    params = AlgorithmParams().with_depth_range(sc.depth_min, sc.depth_max,
                                                float(cams.f))
    gray = torch.as_tensor(sc.images, dtype=torch.float32)
    return dict(sc=sc, cams=cams, params=params, gray=gray,
                rgb=color_from_gray(gray))


def _views(s, V, color):
    imgs = s["rgb"] if color else s["gray"]
    ids = torch.arange(1, V + 1)
    return cuda_direct.make_views(imgs[ids], s["cams"].A[ids],
                                  s["cams"].b[ids], ids)


def _planes(s, C, seed):
    """C candidate planes a pixel: depth near the ground truth (1%
    noise), normals on the camera-facing hemisphere; the last candidate is
    invalid (d = 0) on every third pixel."""
    rng = np.random.default_rng(seed)
    sc, cams = s["sc"], s["cams"]
    gt = np.where(np.isfinite(sc.depth[0]), sc.depth[0],
                  0.5 * (sc.depth_min + sc.depth_max))
    depth = gt * (1.0 + 0.01 * rng.standard_normal((C, H, W)))
    n = torch.as_tensor(rng.standard_normal((C, H, W, 3)),
                        dtype=torch.float32)
    n = geo.hemisphere_flip(geo.normalize(n), geo.view_vectors(cams, H, W))
    rays = geo.pixel_rays(cams, H, W)
    d = geo.plane_d_from_depth(n, rays, torch.as_tensor(depth,
                                                        dtype=torch.float32))
    d[-1].view(-1)[::3] = 0.0
    return n, d


def _stats(s, params, color, parity):
    st = (nc.precompute_ref_stats_color(s["rgb"][0], s["cams"], params)
          if color else ncc.precompute_ref_stats(s["gray"][0], s["cams"],
                                                 params))
    if parity is not None:
        st = (nc.compress_stats_color if color
              else ncc.compress_stats)(st, parity)
    return st


def emulate_kernel(views, s0, sx, sy, stats, params, parity):
    """csrc/direct.cu's loop order in PyTorch, each step rounded as the
    kernel rounds it: per view group (cuda_direct.view_groups) the window
    walked once, per offset the plane coordinate and its finiteness once,
    per (offset, view) A p~ plus the table term, per sample the
    projection, the clamp, floor and fraction from u + 2^23 rounded toward
    -inf (its bits give the integer), the record gather and the moments;
    after each group the epilogue and the aggregation view by view."""
    C, Hc, Wc = s0.shape
    V, CH = len(views.records), views.channels
    Hs, Ws = views.packed[0][0].height, views.packed[0][0].width
    if parity is None:
        xx = torch.arange(Wc, dtype=torch.float32)[None, :].expand(Hc, Wc)
        yy = torch.arange(Hc, dtype=torch.float32)[:, None].expand(Hc, Wc)
    else:
        xx, yy = cb.parity_coords(Hs, Ws, parity)
    terms = cuda_direct.window_terms(views, params)
    offs = ncc.window_offsets(params)
    centers = list(stats.center) if CH == 3 else [stats.center]
    _, _, NB, _ = cuda_direct.instance_for(C, CH, V, params.n_best,
                                           (params.hrad, params.vrad,
                                            params.win_increment))
    shape = (C, Hc, Wc)
    best = torch.full(shape, MAXCOST if NB == 1 else float("inf"))
    second = torch.full(shape, MAXCOST)
    bidx = torch.zeros(shape, dtype=torch.int64)
    nvalid = torch.zeros(shape, dtype=torch.int64)
    top = [torch.full(shape, float("inf")) for _ in range(NB)]
    bad = torch.zeros(shape, dtype=torch.bool)
    bias = 8388608.0
    for group in cuda_direct.view_groups(V, C, CH):
        A, b = views.A, views.b
        ap = {v: [A[v, r, 0] * xx + A[v, r, 1] * yy + A[v, r, 2]
                  for r in range(3)] for v in group}
        acc = {v: [torch.zeros(shape) for _ in range(3)] for v in group}
        for o, (i, j) in enumerate(offs):
            s = (s0 + float(i) * sx) + float(j) * sy
            bad = bad | ~torch.isfinite(s)
            w = stats.weights[o]
            rc = [stats.ref_centered[o, c] if CH == 3
                  else stats.ref_centered[o] for c in range(CH)]
            for v in group:
                ax, ay, az = (ap[v][r] + terms[v, o, r] for r in range(3))
                inv = 1.0 / (az - b[v, 2] * s)
                u = torch.clamp(torch.nan_to_num((ax - b[v, 0] * s) * inv,
                                                 nan=0.0), 0.0, Ws - 1.0)
                vv = torch.clamp(torch.nan_to_num((ay - b[v, 1] * s) * inv,
                                                  nan=0.0), 0.0, Hs - 1.0)
                # __fadd_rd(u, 2^23): the exact sum (float64) rounded down
                # to the float32 grid, whose spacing is 1 in [2^23, 2^24).
                tu = torch.floor(u.double() + bias).float()
                tv = torch.floor(vv.double() + bias).float()
                fx = u - (tu - bias)
                fy = vv - (tv - bias)
                idx = ((tv.view(torch.int32) - 0x4B000000) * Ws
                       + (tu.view(torch.int32) - 0x4B000000))
                rec = views.records[v][idx.long()].to(torch.float32)
                for c in range(CH):
                    v0, v1, v2, v3 = (rec[..., 4 * c + k] for k in range(4))
                    t = v0 + (v1 - v0) * fx
                    bt = v2 + (v3 - v2) * fx
                    d = (t + (bt - t) * fy) - centers[c]
                    ws = w * d
                    acc[v][0] = acc[v][0] + ws
                    acc[v][1] = acc[v][1] + ws * d
                    acc[v][2] = acc[v][2] + ws * rc[c]
        for v in group:
            cost = ncc.ncc_epilogue(*acc[v], stats, params)
            cost = torch.where(bad, params.cost_max, cost)
            if NB == 1:
                if v == 0:
                    best = cost
                else:
                    new = cost < best
                    second = torch.where(new, best,
                                         torch.minimum(second, cost))
                    best = torch.where(new, cost, best)
                    bidx = torch.where(new, v, bidx)
            else:
                nvalid = nvalid + (cost < MAXCOST)
                new = cost < best
                best = torch.where(new, cost, best)
                bidx = torch.where(new, v, bidx)
                t = cost
                for k in range(NB):
                    lo = torch.minimum(top[k], t)
                    t = torch.maximum(top[k], t)
                    top[k] = lo
    ids = views.ids
    if NB == 1:
        snd = best if V == 1 else second
        valid = best < MAXCOST
        return MultiviewCost(
            cost=best, ratio=torch.where(valid, best / snd, 0.0),
            best_view=torch.where(valid, ids[bidx], -1).to(torch.int32))
    nb = torch.clamp(nvalid, max=params.n_best)
    total = torch.zeros(shape)
    for k in range(NB):
        total = torch.where(k < nb, total + top[k], total)
    valid = nb > 0
    snd = top[1] if V > 1 else top[0]
    return MultiviewCost(
        cost=torch.where(valid, total / torch.clamp(nb, min=1).float(),
                         MAXCOST),
        ratio=torch.where(valid, top[0] / snd, 0.0),
        best_view=torch.where(valid, ids[bidx], -1).to(torch.int32))


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def test_color_record_holds_the_packed_bits(scene):
    """The colour record is the three channels' PackedImage corners in
    channel order, then zeros, bit for bit, 32-byte aligned; a grayscale
    view's record is its PackedImage itself."""
    views = _views(scene, 3, color=True)
    for packed, rec in zip(views.packed, views.records):
        assert rec.shape == (H * W, 16) and rec.dtype == torch.bfloat16
        assert rec.data_ptr() % 32 == 0 and rec.is_contiguous()
        for c in range(3):
            assert torch.equal(_bits(rec[:, 4 * c:4 * c + 4]),
                               _bits(packed[c].data))
        assert not _bits(rec[:, 12:]).any()
    gray = _views(scene, 3, color=False)
    for packed, rec in zip(gray.packed, gray.records):
        assert rec is packed[0].data


@pytest.mark.parametrize("box", [(11, 11), (7, 5)])
def test_window_terms_equal_direct_cost_terms(scene, box):
    """T[view, offset, r] is `direct_cost`'s own f32 expression
    float(i) * A[r, 0] + float(j) * A[r, 1], bit for bit, built once per
    views and window."""
    params = dataclasses.replace(scene["params"], box_hsize=box[0],
                                 box_vsize=box[1])
    views = _views(scene, 7, color=False)
    terms = cuda_direct.window_terms(views, params)
    offs = ncc.window_offsets(params)
    assert terms.shape == (7, len(offs), 4) and not terms[..., 3].any()
    expect = torch.stack([torch.stack([torch.stack(
        [float(i) * views.A[v][r, 0] + float(j) * views.A[v][r, 1]
         for r in range(3)]) for (i, j) in offs]) for v in range(7)])
    assert torch.equal(_bits(terms[..., :3]), _bits(expect))
    assert cuda_direct.window_terms(views, params) is terms


def test_view_groups_partition_every_view_in_order():
    """Every view once, in order, in contiguous groups that fit the
    register budget (ACC_BUDGET moment sets), all but the last full."""
    for V in range(1, cuda_direct.MAX_V + 1):
        for C in range(1, cuda_direct.MAX_C + 1):
            for ch in (1, 3):
                groups = cuda_direct.view_groups(V, C, ch)
                assert [v for g in groups for v in g] == list(range(V))
                slots = cuda_direct.candidate_slots(C)
                assert C <= slots
                size = cuda_direct.TILING[(slots, ch)][0]
                assert size == 1 or size * slots <= cuda_direct.ACC_BUDGET
                assert all(len(g) == size for g in groups[:-1])
                assert 0 < len(groups[-1]) <= size
    assert [len(g) for g in cuda_direct.view_groups(7, 1, 3)] == [4, 3]
    assert [len(g) for g in cuda_direct.view_groups(9, 1, 3)] == [4, 4, 1]
    assert len(cuda_direct.view_groups(7, 1, 1)) == 7
    assert len(cuda_direct.view_groups(7, 8, 3)) == 7


def test_python_mirror_reads_the_kernel_constants():
    """ACC_BUDGET, the candidate slots, the tiling table,
    MAX_C/MAX_V/MAX_N_BEST and the default window's offset count in
    cuda_direct are the kernel's."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("ACC_BUDGET") == cuda_direct.ACC_BUDGET
    assert const("MAX_C") == cuda_direct.MAX_C
    assert const("MAX_V") == cuda_direct.MAX_V
    assert const("MAX_N_BEST") == cuda_direct.MAX_N_BEST
    hrad, vrad, inc = cuda_direct.STD_WINDOW
    std = dataclasses.replace(AlgorithmParams(), box_hsize=2 * hrad + 1,
                              box_vsize=2 * vrad + 1, win_increment=inc)
    assert const("STD_O") == len(ncc.window_offsets(std))
    assert (AlgorithmParams().hrad, AlgorithmParams().vrad,
            AlgorithmParams().win_increment) == cuda_direct.STD_WINDOW
    table = re.search(r"#define TSAR_B3_TILING \\\n\s*(\{.*?\}\}\})", src)
    numbers = [int(n) for n in re.findall(r"\d+", table.group(1))]
    assert numbers == [n for slots in cuda_direct.CANDIDATE_SLOTS
                       for ch in (1, 3)
                       for n in cuda_direct.TILING[(slots, ch)]]
    for vg, jb, rows in cuda_direct.TILING.values():
        assert 6 % jb == 0 and rows * 32 <= 1024
    launches = re.findall(r"launch<(\d+)>\(a, vw", src)
    assert tuple(int(n) for n in launches) == cuda_direct.CANDIDATE_SLOTS
    instances = {cuda_direct.instance_for(C, ch, V, nb, w)
                 for C in range(1, 9) for ch in (1, 3)
                 for V in range(1, 33) for nb in range(1, 33)
                 for w in (cuda_direct.STD_WINDOW, (3, 2, 2))}
    assert len(instances) == 36


def _assert_bit_equal(mk, mp):
    assert torch.equal(_bits(mk.cost), _bits(mp.cost))
    nan = torch.isnan(mp.ratio)
    assert torch.equal(torch.isnan(mk.ratio), nan)
    assert torch.equal(_bits(mk.ratio[~nan]), _bits(mp.ratio[~nan]))
    assert torch.equal(mk.best_view, mp.best_view)


@pytest.mark.parametrize("parity,C", [(None, 1), (0, 3), (1, 8)])
@pytest.mark.parametrize("V", [7, 9])
@pytest.mark.parametrize("n_best", [1, 3])
@pytest.mark.parametrize("color", [False, True])
def test_kernel_loop_order_equals_plain(scene, color, n_best, V, parity, C):
    """The kernel's loop order gives the plain version's bits: grayscale
    and colour, n_best 1 and 3, 7 views (one group at one candidate) and
    9 (more than a group holds), the dense grid and both parities, 1, 3
    and 8 candidates (groups of 8, 2 and 1 views) with an invalid one."""
    params = dataclasses.replace(scene["params"], n_best=n_best)
    views = _views(scene, V, color)
    n, d = _planes(scene, C, seed=10 * V + C)
    st = _stats(scene, params, color, parity)
    if parity is not None:
        n, d = cb.parity_compress_vec(n, parity), cb.parity_compress(d,
                                                                     parity)
    s0, sx, sy = ncc.plane_scalars(n, d, st)
    mp = cuda_direct.multiview_cost_direct_plain(views, s0, sx, sy, st,
                                                 params, parity)
    mk = emulate_kernel(views, s0, sx, sy, st, params, parity)
    assert (mp.best_view >= 0).float().mean() > 0.3
    assert (mp.cost[-1] == params.cost_max).float().mean() > 0.3
    _assert_bit_equal(mk, mp)
