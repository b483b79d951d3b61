"""The weighted median plane of a WMF pass: the port's plain version
(tsar_mvs_tpu_torch/ops/wmf.py, every weight sum in kernel B4's fixed
order) against the JAX package, against an emulation of the kernel's loop
order, and kernel B4 (csrc/wmf.cu, wrapper ops/cuda_wmf.py) against the
plain version on the card.

Tolerances:
* `_weighted_median` on dyadic weights: exact, keys and donor index, NaN
  bits included (int32 views). Dyadic sums are exact in any order, so the
  changed sum order cannot show, as in tests/test_wmf.py;
* `_median_plane_plain` against the JAX `_median_plane` on the scene:
  the count of valid samples exact, every other output bit-equal on
  >= 99.9% of pixels, the bound tests/test_torch_tsar.py holds the WMF
  masks to: torch's and XLA's float32 exp differ in the last bit, and the
  two sum orders differ, so a median flips where a cumulative weight sits
  within a rounding of half the total;
* the emulation of the kernel's loop order and the kernel itself against
  the plain version: exact (int32 views of every output).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu.ops import wmf as jwmf
from tsar_mvs_tpu_torch import _build
from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch.ops import cuda_wmf, wmf

torch.set_num_threads(2)
SOURCE = Path(cuda_wmf.__file__).resolve().parents[1] / "csrc" / "wmf.cu"
SIGMA_SPATIAL, SIGMA_COLOR = 2.0, 3.0


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def _dyadic_case(name: str):
    """(key, weight) (O, N) float32 of one case: dyadic weights in
    {0.25 .. 4}, invalid samples weight 0 and key +inf."""
    rng = np.random.default_rng(len(name))
    O, N = {"ties_inf": (121, 512), "negative_zero": (25, 256),
            "all_invalid": (121, 64), "tiny": (3, 64)}[name]
    if name == "negative_zero":
        key = (rng.normal(size=(O, N)) - 0.5).astype(np.float32)
        key[rng.random((O, N)) < 0.2] = 0.0
        key[rng.random((O, N)) < 0.2] = -0.0
    else:
        key = np.round(rng.normal(size=(O, N)) * 8).astype(np.float32) / 4
    weight = (rng.integers(1, 17, size=(O, N)) * 0.25).astype(np.float32)
    invalid = rng.random((O, N)) < 0.2
    if name == "all_invalid":
        invalid[:, ::2] = True
    weight[invalid] = 0.0
    key[invalid] = np.inf
    return key, weight


@pytest.mark.parametrize("name", ["ties_inf", "negative_zero",
                                  "all_invalid", "tiny"])
def test_weighted_median_equals_jax_on_dyadic_weights(name):
    """Ties, +inf invalid keys, negative keys and +-0.0, all-invalid
    pixels (the NaN whose bits are 0xFFFFFFFF) and a 3-sample table: the
    median key and the donor index equal the JAX package's."""
    key, weight = _dyadic_case(name)
    O = key.shape[0]
    payload = np.broadcast_to(np.arange(O, dtype=np.int32)[:, None],
                              key.shape).copy()
    jmed, jidx = jwmf._weighted_median(jnp.asarray(key), jnp.asarray(weight),
                                       jnp.asarray(payload))
    med, idx = wmf._weighted_median(torch.as_tensor(key),
                                    torch.as_tensor(weight), with_index=True)
    np.testing.assert_array_equal(_bits(med.numpy()), _bits(jmed))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(_bits(wmf._weighted_median(
        torch.as_tensor(key), torch.as_tensor(weight)).numpy()), _bits(jmed))
    if name == "all_invalid":
        assert (_bits(med.numpy())[::2] == -1).all()


@pytest.fixture(scope="module")
def fields(scene):
    """The scene's view 0 as one pass's inputs: gray, disparity from the
    true depth with 1% noise and 10% of pixels redrawn within +-30%, the
    true camera-frame normals with noise, 70% of pixels reliable."""
    rng = np.random.default_rng(3)
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    H, W = scene.images.shape[1:]
    gt = np.where(np.isfinite(scene.depth[0]), scene.depth[0],
                  scene.depth_max)
    depth = gt * (1.0 + 0.01 * rng.standard_normal((H, W)))
    depth = np.where(rng.random((H, W)) < 0.1,
                     gt * rng.uniform(0.7, 1.3, (H, W)), depth)
    disp = (float(jc.f) * float(jc.baseline) / depth).astype(np.float32)
    n = scene.normal_cam[0] + 0.05 * rng.standard_normal((H, W, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return {"gray": scene.images[0].astype(np.float32), "disp": disp,
            "normal": n, "reliable": rng.random((H, W)) > 0.3}


def _torch_fields(f, dev="cpu"):
    return tuple(torch.as_tensor(f[k], device=dev)
                 for k in ("gray", "disp", "normal", "reliable"))


@pytest.mark.parametrize("kind,iteration,chunk_rows", [("mark", 1, 32),
                                                       ("fill", 0, 256)])
def test_median_plane_plain_matches_jax(fields, kind, iteration, chunk_rows):
    """One marking pass (radius 40, gap 8; row-chunked) and one fill pass
    (radius 5, gap 1) on the scene: num exact, every other output
    bit-equal on >= 99.9% of pixels (module docstring)."""
    radius, gap, div = wmf.pass_schedule(kind, iteration)
    offsets = wmf.sample_offsets(radius, gap)
    jm = jax.jit(jwmf._median_plane, static_argnums=(4, 5, 6, 7))(
        jnp.asarray(fields["gray"]), jnp.asarray(fields["disp"]),
        jnp.asarray(fields["normal"]), jnp.asarray(fields["reliable"]),
        tuple(offsets), div, SIGMA_SPATIAL, SIGMA_COLOR)
    tm = wmf._median_plane_plain(*_torch_fields(fields), offsets, div,
                                 SIGMA_SPATIAL, SIGMA_COLOR, radius,
                                 chunk_rows)
    np.testing.assert_array_equal(tm.num.numpy(), np.asarray(jm.num))
    for name in ("med_nx", "med_ny", "med_nz", "donor_disp"):
        same = _bits(getattr(tm, name).numpy()) == _bits(getattr(jm, name))
        assert same.mean() >= 0.999, (name, same.mean())
    same = tm.donor_idx.numpy() == np.asarray(jm.donor_idx)
    assert same.mean() >= 0.999, same.mean()


def emulate_kernel(gray, disp, normal, reliable, offsets, factors,
                   inv_sc):
    """csrc/wmf.cu's evaluation order in numpy float32, pixels vectorised:
    the weight and keys per offset (torch's exp on the CPU, as the plain
    version's; a weightless sample keeps the key the kernel reads, not the
    plain version's +inf); per pixel LANES lanes holding the samples
    s + LANES j, each weight sum a lane's samples in j order followed by
    the __shfl_xor_sync butterfly (lane s plus lane s ^ 4, ^ 2, ^ 1). Each
    median is a two-level search by rank: every lane sorts its keys, the
    32 lane quartiles (sorted) are searched for the smallest whose weight
    at or below reaches half; the lanes' blocks of 4 that hold their keys
    between it and the quartile below it are sorted and searched the same
    way. The donor's base and its index descent read a lane's running sums
    of the weight at the median key. Returns the six outputs as numpy
    arrays."""
    L, J = cuda_wmf.LANES, cuda_wmf.PER_LANE
    H, W = gray.shape
    O = len(offsets)
    w = np.zeros((L * J, H, W), np.float32)
    vals = [disp] + [normal[..., c] for c in range(3)]
    # The kernel reads a sample outside the image (or past O) at the pixel
    # itself, and keeps the key of a weightless sample as it reads it.
    key = np.stack([np.broadcast_to(v, (L * J, H, W)) for v in vals]).copy()
    for o, (dx, dy) in enumerate(offsets):
        ys, ye = max(0, -dy), min(H, H - dy)
        xs, xe = max(0, -dx), min(W, W - dx)
        if ys >= ye or xs >= xe:
            continue
        src = (slice(ys + dy, ye + dy), slice(xs + dx, xe + dx))
        dst = (slice(ys, ye), slice(xs, xe))
        t = -np.abs(gray[src] - gray[dst]) * np.float32(inv_sc)
        e = torch.exp(torch.as_tensor(t)).numpy()
        w[o][dst] = np.where(reliable[src], np.float32(factors[o]) * e,
                             np.float32(0.0))
        for c in range(4):
            key[c, o][dst] = vals[c][src]
    key = np.where(key == 0.0, np.float32(0.0), key).view(np.uint32)
    key = np.where(key >> 31 == 1, ~key, key | np.uint32(0x80000000))
    lw = w.reshape(J, L, H, W)
    lane = np.arange(L).reshape(L, 1, 1)

    def tree(acc):
        for off in (4, 2, 1):
            acc = acc + acc[np.arange(L) ^ off]
        return acc[0]

    def lane_sums(masked):
        acc = np.zeros(masked.shape[1:], np.float32)
        for j in range(J):
            acc = acc + masked[j]
        return tree(acc)

    def take(a, i):
        return np.take_along_axis(a, i[None], axis=0)[0]

    half = lane_sums(lw) * np.float32(0.5)

    def search(kc, arr):
        """The smallest index of sorted arr (32, H, W) whose weight at or
        below reaches half: 5 fixed-order sums."""
        lo = np.zeros((H, W), np.int64)
        hi = np.full((H, W), 31, np.int64)
        for _ in range(5):
            mid = (lo + hi) // 2
            ok = lane_sums(np.where(kc <= take(arr, mid), lw,
                                    np.float32(0.0))) >= half
            hi, lo = np.where(ok, mid, hi), np.where(ok, lo, mid + 1)
        return hi

    med = np.zeros((4, H, W), np.uint32)
    for c in range(4):
        kc = key[c].reshape(J, L, H, W)
        run = np.sort(kc, axis=0)
        quart = run[3::4]
        split = np.sort(quart.reshape(4 * L, H, W), axis=0)
        h = search(kc, split)
        hiv = take(split, h)
        lov = take(split, np.maximum(h - 1, 0))
        b = np.where(h > 0, (quart[:3] <= lov).sum(0), 0)
        blk = np.take_along_axis(run, 4 * b[None] + np.arange(4).reshape(
            4, 1, 1, 1), axis=0)
        cand = np.sort(blk.reshape(4 * L, H, W), axis=0)
        med[c] = np.where(half > 0, take(cand, search(kc, cand)), 0)
    k0 = key[0].reshape(J, L, H, W)
    base = lane_sums(np.where(k0 < med[0], lw, np.float32(0.0)))
    at = np.where(k0 == med[0], lw, np.float32(0.0))
    pre = [np.zeros((L, H, W), np.float32)]
    for j in range(J):
        pre.append(pre[-1] + at[j])
    pre = np.stack(pre)
    nbits = max(1, (O - 1).bit_length())
    mi = np.zeros((H, W), np.int64)
    for i in range(nbits):
        mid = mi | (1 << (nbits - 1 - i))
        upto = np.clip((mid - lane + L - 1) // L, 0, J)
        acc = tree(np.take_along_axis(pre, upto[None], axis=0)[0])
        mi = np.where(base + acc < half, mid, mi)
    mi = np.minimum(mi, O - 1)
    as_float = np.where(med >> 31 == 1, med & np.uint32(0x7FFFFFFF),
                        ~med).view(np.float32)
    return (as_float[1], as_float[2], as_float[3], mi.astype(np.int64),
            as_float[0], (w > 0.0).sum(0))


def _corner(f):
    """The scene's 48x64 corner with tied and non-finite disparities, -0.0
    normal components, an unreliable block and all-invalid pixels."""
    f = {k: np.array(v[:48, :64]) for k, v in f.items()}
    f["disp"][24:, 32:] = np.round(f["disp"][24:, 32:] * 4) / 4
    f["normal"][24:, 32:] = np.round(f["normal"][24:, 32:] * 8) / 8
    f["disp"].reshape(-1)[::53] = np.inf
    f["disp"].reshape(-1)[1::59] = np.nan
    f["normal"].reshape(-1)[2::61] = -0.0
    f["reliable"][:24, :24] = False
    return f


def _adversarial(f, name):
    """Case `name` of kernel_times.wmf_cases on the scene's 48x64 corner,
    as numpy fields."""
    call = {k: torch.as_tensor(v) for k, v in f.items()}
    got = kt.wmf_cases(call, 48, 64)[name]
    return {k: got[k].numpy() for k in ("gray", "disp", "normal",
                                          "reliable")}


# (case, pass kind, pass iteration): the corner at a marking and a fill
# pass, each stress case of kernel_times.wmf_cases at one of them.
EMULATION_CASES = [("corner", "mark", 2), ("corner", "fill", 1),
                   ("slanted", "fill", 1), ("equal", "mark", 2),
                   ("one_valid", "fill", 1), ("cross_zero", "mark", 2),
                   ("nan_heavy", "fill", 1)]


@pytest.mark.parametrize("case,kind,iteration", EMULATION_CASES)
def test_kernel_order_emulation_equals_plain(fields, case, kind, iteration):
    """An emulation of the kernel's search order (its pivot rule
    included) equals the plain version's radix descent to the bit: the
    scene's corner with ties, non-finite keys, -0.0 and all-invalid
    pixels; keys sorted along the offset order; 121 equal keys; a single
    valid sample; keys of both signs; a NaN disparity (0x7FFFFFFF) with
    most of the weight."""
    f = _corner(fields) if case == "corner" else _adversarial(fields, case)
    radius, gap, div = wmf.pass_schedule(kind, iteration)
    offsets = wmf.sample_offsets(radius, gap)
    factors = wmf.spatial_factors(offsets, div, SIGMA_SPATIAL)
    got = emulate_kernel(f["gray"], f["disp"], f["normal"], f["reliable"],
                         offsets, factors, 1.0 / SIGMA_COLOR ** 2)
    plain = wmf._median_plane_plain(*_torch_fields(f), offsets, div,
                                    SIGMA_SPATIAL, SIGMA_COLOR, radius)
    for name, a, b in zip(plain._fields, got, plain):
        np.testing.assert_array_equal(
            np.ascontiguousarray(a).view(np.int32),
            np.ascontiguousarray(b.numpy()).view(np.int32), err_msg=name)
    num = plain.num.numpy()
    if case in ("corner", "one_valid"):
        assert (num == 0).any() and (num > 0).any()
    if case == "one_valid":
        assert num.max() == 1
    if case == "nan_heavy":
        assert (_bits(plain.donor_disp.numpy()) == 0x7FFFFFFF).mean() > 0.5


def test_python_mirror_reads_the_kernel_constants():
    """LANES and PER_LANE of cuda_wmf (and so the plain version's sum
    order) are the kernel's, and the search the emulation mirrors is the
    kernel's: 32 splitters (4 quartiles of 8 lanes) searched in 5 steps,
    twice, each step a sum of the weights at or below a key; the donor's
    base the sum below the median key."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("LANES") == cuda_wmf.LANES == wmf.LANES
    assert const("PER_LANE") == cuda_wmf.PER_LANE
    assert cuda_wmf.MAX_O >= 121
    assert "__shfl_xor_sync(FULL, p, 4)" in src
    assert re.search(r"constexpr int SPLIT = 4 \* LANES;", src)
    assert "for (int step = SPLIT / 2; step > 0; step >>= 1)" in src
    assert src.count("search(split, w, k, half)") == 2
    assert "q[b] = k[4 * b + 3];" in src
    assert "setp.le.u32" in src and "setp.lt.u32" in src
    assert "weight_upto<true>(w, k, mc)" in src


def test_b4_bound_counts_the_function_not_the_descent():
    """B4's bound counts what a weighted median plane needs whatever
    computes it: 5 operations a sample for the weight and the total, about
    log2 O fixed-order sums of O adds for each of the four medians (a
    search over the sorted keys, not the plain version's 32-step descent
    nor B4's 10 sums), the donor's base and its index descent. At
    1344x2048 with 121 offsets that is 4,968 operations a pixel, bound by
    operations at about 0.2 ms, and 0.408 ms at the rate of single
    rounded adds (the ceiling)."""
    O, steps = 121, 7
    assert kt.b4_flops(1, O) == 5 * O + 4 * steps * O + O + steps * (O + 1)
    assert kt.b4_flops(1, O) == 4968
    assert kt.b4_flops(10, 2) == 10 * (5 * 2 + 4 * 2 + 2 + 3)
    b = kt.b4_bound(1344, 2048, O)
    assert b["bound_by"] == "operations"
    assert b["bytes"] == 53 * 1344 * 2048
    assert 0.20 < b["bound_ms"] < 0.21
    # Every operation counted is a single rounded add or multiply: at
    # half the 67 TFLOP/s that counts an FMA as two, 0.408 ms.
    assert b["ceiling_ms"] == pytest.approx(2 * b["operations_ms"])
    assert 0.40 < b["ceiling_ms"] < 0.41


def test_cpu_tensors_never_reach_the_build(fields, monkeypatch):
    """median_plane on CPU tensors runs the plain version without loading
    the kernel library, and its wmf passes launch nothing."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(_build, "load_library", refuse)
    radius, gap, div = wmf.pass_schedule("fill", 0)
    offsets = wmf.sample_offsets(radius, gap)
    args = (*_torch_fields(fields), offsets, div, SIGMA_SPATIAL,
            SIGMA_COLOR, radius)
    before = cuda_wmf.LAUNCHES
    got = wmf.median_plane(*args, chunk_rows=40)
    want = wmf._median_plane_plain(*args, 256)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    assert cuda_wmf.LAUNCHES == before


def test_cuda_tensor_with_a_failing_launch_raises(fields, monkeypatch):
    """A CUDA tensor goes to the kernel: a launch that returns a CUDA error
    raises and is not counted, and malformed inputs raise before any
    launch. (Tensors pose as CUDA ones and the library is a stand-in.)"""
    class Lib:
        calls = 0

        def tsar_wmf_median(self, *args):
            Lib.calls += 1
            return 700

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "load_library", Lib)
    offsets = wmf.sample_offsets(5, 1)
    args = (*_torch_fields(fields), offsets, 1.0, SIGMA_SPATIAL,
            SIGMA_COLOR, 5)
    before = cuda_wmf.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wmf.median_plane(*args)
    assert Lib.calls == 1 and cuda_wmf.LAUNCHES == before
    gray, disp, normal, reliable = _torch_fields(fields)
    with pytest.raises(TypeError):
        wmf.median_plane(gray, disp, normal, reliable.float(),
                         *args[4:])
    with pytest.raises(ValueError):
        wmf.median_plane(gray, disp[:-1], normal, reliable, *args[4:])
    with pytest.raises(ValueError):
        wmf.median_plane(*args[:4], wmf.sample_offsets(6, 1), *args[5:])
    assert Lib.calls == 1


# --- kernel B4 on the card --------------------------------------------------

PASSES = [("mark", i) for i in range(4)] + [("fill", i) for i in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,iteration", PASSES)
def test_b4_kernel_matches_plain_on_card(fields, kind, iteration):
    """Kernel B4 against its plain version on the card at each of the ten
    passes: the scene tiled to 288x384 and cut by kernel_times.wmf_crop
    (image border, all-invalid pixels at every radius, tied keys, +-inf
    and NaN disparities, -0.0): one launch, every output equal on its
    int32 view. Needs an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    tiled = {k: torch.as_tensor(np.tile(v, (3, 3) + (1,) * (v.ndim - 2)),
                                device=dev) for k, v in fields.items()}
    radius, gap, div = wmf.pass_schedule(kind, iteration)
    call = kt.wmf_crop({**tiled, "offsets": wmf.sample_offsets(radius, gap),
                        "spatial_div": div, "sigma_spatial": SIGMA_SPATIAL,
                        "sigma_color": SIGMA_COLOR, "radius": radius})
    args = kt.b4_args(call)
    before = cuda_wmf.LAUNCHES
    mk = wmf.median_plane(*args)
    mp = wmf._median_plane_plain(*args)
    torch.cuda.synchronize()
    assert cuda_wmf.LAUNCHES == before + 1
    agree = kt.b4_agreement(mk, mp)
    assert agree["max_abs_err"] == 0, agree
    assert (mp.num == 0).any() and (mp.num > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("corner",) + kt.WMF_CASES)
@pytest.mark.parametrize("kind,iteration", [("mark", 0), ("fill", 1)])
def test_b4_kernel_matches_plain_on_adversarial_inputs(fields, case, kind,
                                                       iteration):
    """Kernel B4 against its plain version on the card on the emulation
    test's stress inputs (kernel_times.wmf_cases, and the corner of
    kernel_times.wmf_crop) cut to 256x384 from the scene tiled 3x3, at
    the widest marking pass and a fill pass: every output equal on its
    int32 view. Needs an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    tiled = {k: torch.as_tensor(np.tile(v, (3, 3) + (1,) * (v.ndim - 2)),
                                device=dev) for k, v in fields.items()}
    radius, gap, div = wmf.pass_schedule(kind, iteration)
    call = {**tiled, "offsets": wmf.sample_offsets(radius, gap),
            "spatial_div": div, "sigma_spatial": SIGMA_SPATIAL,
            "sigma_color": SIGMA_COLOR, "radius": radius}
    call = (kt.wmf_crop(call) if case == "corner"
            else kt.wmf_cases(call, 256, 384)[case])
    args = kt.b4_args(call)
    mk = wmf.median_plane(*args)
    mp = wmf._median_plane_plain(*args)
    torch.cuda.synchronize()
    agree = kt.b4_agreement(mk, mp)
    assert agree["max_abs_err"] == 0, agree


def test_b4_parts_edit_the_kernel_source():
    """Every part that `kernel_times b4-parts` takes out of B4 names text
    that csrc/wmf.cu holds, so the command times the kernel as it is."""
    src = SOURCE.read_text()
    for part, edits in kt.B4_PARTS.items():
        for old, new in edits:
            assert src.count(old) >= 1 and old != new, part
