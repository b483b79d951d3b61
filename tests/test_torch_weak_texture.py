"""Weak-texture detection: the dispatch (a CPU device takes the plain
version, numpy and scipy; a CUDA device kernel B7), kernel B7's wrapper
(ops/cuda_weak_texture.py) and what the host makes for it, held to the
numpy code it must equal to the bit: the mirror taps and the summation
order of pyr_down, the trig table and rho arithmetic of hough_segments,
linspace's arithmetic in draw_segment, the border cleanup, and the
union-find rules that give connect()'s raster first-encounter labels.
B7 itself runs only on the card (tests/test_torch_weak_texture_cuda.py).

Every comparison is exact: float64 on its int64 view.
"""

from __future__ import annotations

import ctypes
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch import trace
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models import weak_texture as wt
from tsar_mvs_tpu_torch.ops import cuda_weak_texture as b7

SOURCE = Path(b7.__file__).resolve().parents[1] / "csrc" / "weak_texture.cu"


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).view(np.int64)


# --- the dispatch ------------------------------------------------------------

@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_cpu_device_takes_the_plain_version(device):
    gray, kw, levels = kt.b7_case("dashed_0")
    params = AlgorithmParams(**kw)
    want = wt.detect_weak_texture(gray, params, levels)
    trace.clear("weak_texture.plain_calls", "launches.b7",
                "weak_texture.segments")
    got = wt.detect_weak_texture(gray, params, levels, device=device)
    assert kt.b7_mismatch(got, want) == {f: 0 for f in kt.B7_FIELDS}
    assert trace.counter("weak_texture.plain_calls") == 1
    assert trace.counter("launches.b7") == 0
    assert trace.counter("weak_texture.segments") > 0


def test_other_devices_raise():
    gray, kw, levels = kt.b7_case("constant")
    with pytest.raises(ValueError, match="no kernel"):
        wt.detect_weak_texture(gray, AlgorithmParams(**kw), levels,
                               device="meta")


@pytest.mark.parametrize("gray, levels, error", [
    (torch.zeros(2, 64, 64), 2, ValueError),           # not (H, W)
    (torch.zeros(64, 64, dtype=torch.int32), 2, TypeError),
    (torch.zeros(64, 64, dtype=torch.float16), 2, TypeError),
    (torch.zeros(64, 64), 7, ValueError),               # levels
    (torch.zeros(4, 64), 2, ValueError),                # a 1-row level
    (torch.zeros(64, 64), 2, ValueError),               # on the CPU
    (np.zeros((64, 64), np.float32), 2, ValueError),    # not a tensor
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(gray, levels,
                                                        error):
    with pytest.raises(error):
        b7.Run(gray, 4, 25, 12, 12, 3, 2.5, levels)


def test_upload_keeps_float_and_widens_the_rest():
    assert b7.upload(np.zeros((4, 4), np.float32), "cpu").dtype == \
        torch.float32
    assert b7.upload(np.zeros((4, 4), np.float64), "cpu").dtype == \
        torch.float64
    got = b7.upload(np.arange(16, dtype=np.uint8).reshape(4, 4), "cpu")
    assert got.dtype == torch.float64 and got[3, 3] == 15


# --- the host's tables and the launch plan ------------------------------------

def test_trig_table_is_hough_segments_angles():
    thetas = np.deg2rad(np.arange(180))
    np.testing.assert_array_equal(
        _bits(b7.trig_table()),
        _bits(np.concatenate([np.cos(thetas), np.sin(thetas)])))


def test_rho_from_the_table_is_hough_segments_rho():
    """x cos + y sin with each product rounded, as the kernel computes it
    from the uploaded table, against the broadcast expression of
    hough_segments, on every pixel of a 2K view's quarter-scale level."""
    trig = b7.trig_table()
    cos_t, sin_t = trig[:180], trig[180:]
    ys, xs = np.mgrid[0:336, 0:512]
    pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)[::7]
    want = np.rint(pts[:, 0:1] * cos_t + pts[:, 1:2] * sin_t)
    got = np.empty_like(want)
    for t in range(180):
        got[:, t] = np.rint(np.add(np.multiply(pts[:, 0], cos_t[t]),
                                   np.multiply(pts[:, 1], sin_t[t])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", list(range(1, 13)) + [97, 120, 160, 336, 512])
def test_mirror_is_scipys_mirror_border(n):
    """The host's mirror index is the sample that correlate1d's "mirror"
    border reads, at every position and tap of a 5-tap filter: row j of
    the identity correlated with a one-hot filter is 1 at position i
    exactly where tap k of position i reads sample j."""
    for k in range(5):
        taps = np.zeros(5)
        taps[k] = 1.0
        got = ndimage.correlate1d(np.eye(n), taps, axis=1, mode="mirror")
        want = np.zeros((n, n))
        want[[b7.mirror(i + k - 2, n) for i in range(n)], range(n)] = 1.0
        np.testing.assert_array_equal(got, want)


def _pyr_down_kernel_order(img: np.ndarray, rows: np.ndarray,
                           cols: np.ndarray) -> np.ndarray:
    """weak_pyr_kernel in numpy: the vertical 5 taps at each kept row, for
    the horizontal taps' columns, then the horizontal 5; each as
    NI_Correlate1D sums: centre first, then the pair at distance 2, then
    the pair at distance 1."""
    w0, w1, w2 = 0.0625, 0.25, 0.375

    def five(x0, x1, x2, x3, x4):
        s = np.multiply(x2, w2)
        s = np.add(s, np.multiply(np.add(x0, x4), w0))
        return np.add(s, np.multiply(np.add(x1, x3), w1))

    x = img.astype(np.float64)
    v = five(*(x[rows[:, k]] for k in range(5)))          # (dh, W)
    return five(*(v[:, cols[:, k]] for k in range(5)))    # (dh, dw)


@pytest.mark.parametrize("shape", [(1344, 2048), (480, 640), (193, 257),
                                   (1, 5), (2, 3), (3, 7), (5, 2)])
def test_mirror_taps_and_order_give_pyr_down(shape):
    """Both levels of a 2K and a dino view, odd and tiny sides: the
    kernel's taps and order equal pyr_down to the bit, on float32-valued
    input spread over many exponents (where the order matters)."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    img = (rng.uniform(0, 255, shape) * rng.uniform(0, 1, shape) ** 8
           ).astype(np.float32)
    down = img
    for level in range(2):
        if min(down.shape) < 1:
            break
        got = _pyr_down_kernel_order(down, b7.mirror_taps(down.shape[0]),
                                     b7.mirror_taps(down.shape[1]))
        want = wt.pyr_down(down)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        down = want


def test_a_different_order_would_show():
    """The pyramid test can see an order: the five taps summed left to
    right differ from pyr_down on such input."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (64, 96)) * rng.uniform(0, 1, (64, 96)) ** 8
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    taps = b7.mirror_taps(96)
    left = sum(img[:, taps[:, j]] * k[j] for j in range(5))
    right = ndimage.correlate1d(img, k, axis=1, mode="mirror")[:, ::2]
    assert (left != right).any()


@pytest.mark.parametrize("H, W, levels, floor, kernels", [
    (1344, 2048, 2, 5000, 17), (480, 640, 2, 5000, 17),
    (96, 128, 2, 5000, 10), (48, 64, 0, 25, 16), (97, 130, 1, 25, 16)])
def test_plan_for_the_benchmark_shapes(H, W, levels, floor, kernels):
    p = b7.plan(H, W, levels, floor)
    h, w = p.small
    assert (h, w) == (-(-H // 2 ** levels), -(-W // 2 ** levels))
    # hough_segments' accumulator: diag and its (2 diag + 1) x 180 cells.
    assert p.diag == int(np.ceil(np.hypot(h, w)))
    assert p.rows == 2 * p.diag + 1
    assert len(p.kernels) == kernels
    stages = b7.stage_kernels(p)
    assert sum(stages.values(), ()) == p.kernels


def test_plan_2k_and_dino_in_full():
    p = b7.plan(1344, 2048, 2, 5000)
    assert (p.small, p.r_max, p.clusters, p.diag, p.rows, p.cap) \
        == ((336, 512), 34, 8, 613, 1227, 1024)
    assert p.kernels == ("pyr", "pyr", "roberts", "merge", "count",
                         "select", "bcount", "boffsets", "bfill", "peaks",
                         "init2", "merge", "roots", "scan", "rootlabel",
                         "stats", "finish")
    # A block's 12 angles x 1227 bins at 16 bits, then 1024 points.
    assert p.peak_smem == 12 * 1227 * 2 + 8 + 36 * 1024
    d = b7.plan(480, 640, 2, 5000)
    assert (d.small, d.r_max, d.clusters, d.diag, d.cap) == \
        ((120, 160), 3, 3, 200, 320)
    # However many regions, one launch: the clusters loop over them.
    many = b7.plan(1344, 2048, 2, 10)
    assert many.r_max > 1000 and many.clusters == b7.PEAK_CLUSTERS
    assert many.kernels.count("peaks") == 1
    assert b7.plan(96, 128, 2, 5000).r_max == 0
    # The source resolution of the 2K configuration (6048x4032) fits a
    # peak block too.
    assert b7.plan(4032, 6048, 2, 5000).peak_smem <= b7.MAX_PEAK_SMEM


@pytest.mark.parametrize("shape", [(120, 160), (49, 65), (24, 32)])
def test_cap_holds_every_rho_bin(shape):
    """No (rho, theta) cell of hough_segments collects more pixels than a
    peak block holds, even with every pixel of the level on the
    boundary."""
    h, w = shape
    p = b7.plan(4 * h, 4 * w, 2, 0)
    ys, xs = np.mgrid[0:h, 0:w]
    trig = b7.trig_table()
    most = 0
    for t in range(180):
        rho = np.rint(xs.ravel() * trig[t] + ys.ravel() * trig[180 + t])
        most = max(most, np.unique(rho, return_counts=True)[1].max())
    assert most <= 2 * max(h, w) <= p.cap
    assert p.peak_smem <= b7.MAX_PEAK_SMEM


# --- the kernel's other rules, against the numpy code ------------------------

def _linspace_kernel(a: int, b: int, n: int) -> np.ndarray:
    if n == 1:
        return np.array([a])
    step = (b - a) / (n - 1)
    out = np.array([np.rint(np.add(np.multiply(float(k), step), float(a)))
                    for k in range(n)])
    out[-1] = b
    return out.astype(int)


def test_segment_points_are_draw_segments():
    """lin_at: k times (b - a) / (n - 1) plus a, the last point b, against
    draw_segment's rint(linspace) on every pair of a 40-pixel range."""
    for a in range(-3, 40, 3):
        for b in range(0, 40):
            for n in (1, abs(b - a) + 1, abs(b - a) + 7):
                want = np.rint(np.linspace(a, b, n)).astype(int)
                np.testing.assert_array_equal(_linspace_kernel(a, b, n),
                                              want)


def _cleanup_numpy(e: np.ndarray) -> np.ndarray:
    e = e.copy()
    e[:, 0] = np.where(e[:, 1] == 0, 0, e[:, 0])
    e[:, -1] = np.where(e[:, -2] == 0, 0, e[:, -1])
    e[0, :] = np.where(e[1, :] == 0, 0, e[0, :])
    e[-1, :] = np.where(e[-2, :] == 0, 0, e[-1, :])
    return e


def _cleanup_kernel(e: np.ndarray) -> np.ndarray:
    """weak_init2_kernel's c4(): each pixel from the drawn edges alone."""
    h, w = e.shape

    def c1(y, x):
        return 0 if x == 0 and e[y, 1] == 0 else e[y, x]

    def c2(y, x):
        return 0 if x == w - 1 and c1(y, w - 2) == 0 else c1(y, x)

    def c3(y, x):
        return 0 if y == 0 and c2(1, x) == 0 else c2(y, x)

    def c4(y, x):
        return 0 if y == h - 1 and c3(h - 2, x) == 0 else c3(y, x)

    return np.array([[c4(y, x) for x in range(w)] for y in range(h)],
                    e.dtype)


@pytest.mark.parametrize("shape", [(2, 2), (2, 5), (5, 2), (3, 3), (6, 9)])
def test_border_cleanup_per_pixel_is_the_numpy_steps(shape):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    for _ in range(50):
        e = np.where(rng.random(shape) < 0.5, 255, 0).astype(np.uint8)
        np.testing.assert_array_equal(_cleanup_kernel(e), _cleanup_numpy(e))


def _components_kernel_rules(edges: np.ndarray) -> np.ndarray:
    """The kernel's union-find, run in order: first parents from
    run_parent (runs inside 32-pixel warps of the raster), vertical unions
    only where the left neighbour does not join the same two runs; roots
    by hooking the larger under the smaller; then labels as 1 + the
    exclusive prefix sum of the root flags."""
    h, w = edges.shape
    n = h * w
    e = edges.ravel() != 0
    parent = np.full(n, -1)
    for i in range(n):
        if e[i]:
            continue
        lane, base = i % 32, i - i % 32
        start = None
        for j in range(i, base - 1, -1):
            if (j % w == 0) or e[j - 1]:
                start = j
                break
        parent[i] = start if start is not None else (
            i - 1 if lane == 0 else base)

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    for i in range(w, n):
        if e[i] or e[i - w]:
            continue
        if i % w and not e[i - 1] and not e[i - w - 1]:
            continue
        a, b = sorted((find(i), find(i - w)))
        parent[b] = a
    roots = np.array([not e[i] and find(i) == i for i in range(n)])
    number = np.cumsum(roots) - roots + 1
    return np.array([0 if e[i] else number[find(i)] for i in range(n)]
                    ).reshape(h, w)


@pytest.mark.parametrize("shape", [(12, 32), (9, 45), (20, 7), (33, 70)])
def test_union_find_rules_give_connects_labels(shape):
    rng = np.random.default_rng(shape[1])
    for density in (0.2, 0.45, 0.6):
        edges = np.where(rng.random(shape) < density, 255, 0).astype(
            np.uint8)
        edges[3, :] = 0          # a run across warp boundaries
        labels, _, _ = wt.connect(edges, 0)
        np.testing.assert_array_equal(_components_kernel_rules(edges),
                                      labels)


def _hough_kernel_order(mask, threshold, min_len, gap, max_lines=64):
    """weak_peaks_kernel's loop in numpy: the first maximum (signed), the
    alive points on its line sorted by (proj, raster index), runs split
    at gaps > gap, the used points' votes taken back."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return []
    h, w = mask.shape
    rid = ys * w + xs
    trig = b7.trig_table()
    cos_t, sin_t = trig[:180], trig[180:]
    diag = int(np.ceil(np.hypot(h, w)))
    x, y = xs.astype(np.float64), ys.astype(np.float64)
    rhos = np.rint(x[:, None] * cos_t + y[:, None] * sin_t).astype(
        np.int64) + diag
    acc = np.zeros((2 * diag + 1, 180), np.int32)
    np.add.at(acc, (rhos.ravel(), np.tile(np.arange(180), x.size)), 1)
    alive = np.ones(x.size, bool)
    segs = []
    for _ in range(max_lines):
        flat = int(np.argmax(acc))
        r, t = divmod(flat, 180)
        if acc[r, t] < threshold:
            break
        idx = np.nonzero(alive & (rhos[:, t] == r))[0]
        if idx.size == 0:
            acc[r, t] = 0
            continue
        key = (-x[idx]) * sin_t[t] + y[idx] * cos_t[t]
        order = np.lexsort((rid[idx], key))
        idx, key = idx[order], key[order]
        starts = [0] + [i for i in range(1, idx.size)
                        if key[i] - key[i - 1] > gap]
        used = False
        for s, e in zip(starts, starts[1:] + [idx.size]):
            if key[e - 1] - key[s] >= min_len:
                segs.append((int(xs[idx[s]]), int(ys[idx[s]]),
                             int(xs[idx[e - 1]]), int(ys[idx[e - 1]])))
                alive[idx[s:e]] = False
                np.add.at(acc, (rhos[idx[s:e]].ravel(),
                                np.tile(np.arange(180), e - s)), -1)
                used = True
        if not used:
            acc[r, t] = 0
    return segs


@pytest.mark.parametrize("name", ["dashed_0", "dashed_1", "dashed_2",
                                  "dashed_odd", "dashed_levels1",
                                  "float_levels0", "dashed_dino"])
def test_peak_loop_order_gives_hough_segments(name):
    """The kernel's order on every pass-1 region of the stress inputs:
    the same segments as hough_segments, in the same order; cells zeroed
    at a peak do go negative there (the argmax is signed)."""
    gray, kw, levels = kt.b7_case(name)
    p = AlgorithmParams(**kw)
    down = gray
    for _ in range(levels):
        down = wt.pyr_down(down)
    edges = np.where(wt.roberts(down) > p.rob_thr, 255, 0).astype(np.uint8)
    labels, _, weak = wt.connect(edges, p.weak_text_num)
    assert weak
    for region in weak:
        mask = wt.region_boundary(labels, region)
        want = [(s.x1, s.y1, s.x2, s.y2) for s in wt.hough_segments(
            mask, p.hough_thr, p.min_line_length, p.max_line_gap)]
        assert _hough_kernel_order(mask, p.hough_thr, p.min_line_length,
                                   p.max_line_gap) == want


def test_stress_inputs_split_regions():
    """The dashed cases split pass-1 regions (segments drawn, more regions
    over the floor after); noise has none over the floor; the constant
    image stays integer-valued through the pyramid (Roberts' integer
    branch)."""
    for name in ("dashed_0", "dashed_2", "dashed_odd", "dashed_2k"):
        gray, kw, levels = kt.b7_case(name)
        p = AlgorithmParams(**kw)
        trace.clear("weak_texture.segments")
        out = wt.detect_weak_texture(gray, p, levels)
        assert trace.counter("weak_texture.segments") >= 10, name
        down = gray
        for _ in range(levels):
            down = wt.pyr_down(down)
        edges = np.where(wt.roberts(down) > p.rob_thr, 255, 0)
        _, _, weak0 = wt.connect(edges.astype(np.uint8), p.weak_text_num)
        assert (out.counts[1:] > p.weak_text_num).sum() > len(weak0), name
    gray, kw, _ = kt.b7_case("noise")
    down = wt.pyr_down(wt.pyr_down(gray))
    edges = np.where(wt.roberts(down) > 4, 255, 0).astype(np.uint8)
    _, counts, weak = wt.connect(edges, kw["weak_text_num"])
    assert weak == [] and counts[1:].max() <= kw["weak_text_num"]
    gray, _, _ = kt.b7_case("constant")
    down = wt.pyr_down(wt.pyr_down(gray))
    assert np.array_equal(down, np.rint(down))


# --- the C interface ----------------------------------------------------------

def _c_struct(name: str) -> list[tuple[str, str]]:
    """(field, C type) of a struct of csrc/weak_texture.cu, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name,
                     SOURCE.read_text(), re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = re.sub(r"\[[^]]*\]", "", " ".join(decl.split()))
        if not decl:
            continue
        first, *rest = (d.strip() for d in decl.split(","))
        *words, last = first.split()
        ctype = " ".join(w for w in words if w != "const")
        for item in [last, *rest]:
            stars = "*" * (len(item) - len(item.lstrip("*")))
            fields.append((item.lstrip("*"), (ctype + stars).replace(
                " *", "*")))
    return fields


def test_args_mirror_the_c_struct():
    c = _c_struct("WeakArgs")
    py = [(name, t) for name, t in b7.Args._fields_]
    assert [n for n, _ in c] == [n for n, _ in py]
    kinds = {ctypes.c_void_p: "*", ctypes.c_double: "double",
             ctypes.c_int: "int"}
    for (name, ctype), (_, pytype) in zip(c, py):
        if pytype in kinds:
            want = kinds[pytype]
            assert ctype.endswith("*") if want == "*" else ctype == want, \
                name
        else:
            assert ctype == ("int" if pytype._type_ is ctypes.c_int
                             else "long long"), name


def test_row_stat_and_constants_mirror_the_source():
    src = SOURCE.read_text()
    assert [n for n, _ in _c_struct("Row")] == ["cenx", "ceny", "count",
                                                "size", "text", "pad"]
    assert b7.ROW.itemsize == 32
    assert [n for n, _ in _c_struct("Stat")] == ["cnt", "minx", "maxx",
                                                 "miny", "maxy", "pad",
                                                 "sx", "sy"]
    assert b7.STAT_BYTES == 6 * 4 + 2 * 8
    for name in ("PX", "SCAN_THREADS", "THETAS", "MAX_LEVELS", "CLUSTER",
                 "PEAK_CLUSTERS"):
        m = re.search(r"constexpr int %s = (\d+);" % name, src)
        assert int(m.group(1)) == getattr(b7, name), name
    enum = re.search(r"enum \{ (SC_\w+(?:, SC_\w+)*), SC_COUNT = (\d+) \}",
                     src)
    assert [s.lower()[3:] for s in enum.group(1).split(", ")] == [
        "nonint", "r", "segments", "m", "overflow"]
    assert len(b7.SCALARS) == 5 and int(enum.group(2)) == b7.N_SCALARS
    assert re.search(r"return acc_bytes\(rows\) \+ cap \* %d;"
                     % b7.PEAK_BYTES_PER_POINT, src)
    assert inspect.signature(wt.hough_segments).parameters[
        "max_lines"].default == b7.MAX_LINES
    assert re.search(r"return \(\(NTH_MAX \* rows \+ 1\) / 2 \* 4 \+ 15\) / 16 "
                     r"\* 16;", src)


def test_buffers_are_laid_apart_and_aligned():
    p = b7.plan(1344, 2048, 2, 5000)
    zoff, zbytes, woff, wbytes, ooff, obytes = b7.buffers(p)
    for offs, total in ((zoff, zbytes), (woff, wbytes), (ooff, obytes)):
        starts = sorted(offs.values())
        assert all(s % 16 == 0 for s in starts) and starts[-1] <= total
    assert ooff["out_small"] == 4 * 1344 * 2048
    assert obytes >= ooff["table"] + b7.ROW.itemsize * (336 * 512 + 1)
