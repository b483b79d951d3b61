"""Weighted median filters over the plane field (port of
``tsar_mvs_tpu.ops.wmf``).

* ``wmf_mark_outliers``: coarse-to-fine passes (radius 80/2^i, gap
  16/2^i) computing the bilateral weighted median plane of reliable
  neighbours; a pixel becomes unreliable when the median plane's
  disparity drifts more than wmf_drift_thr/2^i from its own.
* ``wmf_fill``: fine passes (radius 5*2^i, gap 2^i) filling unreliable
  textured pixels with the weighted median plane when at least 32/2^i
  reliable samples exist.

Each pass computes its median plane with ``median_plane``: kernel B4
(``ops/cuda_wmf.py``, ``csrc/wmf.cu``) on CUDA tensors, the plain version
``_median_plane_plain`` on CPU tensors. The weighted median is a radix
bit descent over an order-preserving integer image of the keys, with the
donor sample recovered by a second descent over the tied keys. Keys are
int64 holding the uint32 image (torch's uint32 lacks most ops); the
order is the same. Every weight sum runs in the kernel's order
(``fixed_sum``), so the plain version equals the kernel to the bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.ops import cuda_wmf
from tsar_mvs_tpu_torch.ops.checkerboard import shift_const

_SIGN = 0x80000000
_MASK = 0xFFFFFFFF
# The ordered key of +inf: the key of an invalid sample.
KEY_INF = 0xFF800000
# Lanes a pixel in kernel B4: the weight sums' order (`fixed_sum`).
LANES = cuda_wmf.LANES


def sample_offsets(radius: int, gap: int) -> list[tuple[int, int]]:
    """(dx, dy) grid: i, j in [-radius, radius] step gap."""
    rng = list(range(-radius, radius + 1, gap))
    return [(i, j) for i in rng for j in rng]


def pass_schedule(kind: str, iteration: int) -> tuple[int, int, float]:
    """(radius, gap, spatial_div) of marking pass ("mark") or fill pass
    ("fill") `iteration`."""
    po = 2 ** iteration
    if kind == "mark":
        return 80 // po, 16 // po, float(2 ** (3 - iteration))
    return 5 * po, po, float(po)


class _MedianResult(NamedTuple):
    med_nx: torch.Tensor
    med_ny: torch.Tensor
    med_nz: torch.Tensor
    donor_idx: torch.Tensor   # (H, W) int64 index into the offset table
    donor_disp: torch.Tensor  # (H, W) disparity of the median donor
    num: torch.Tensor         # (H, W) count of valid samples


def float_to_ordered_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone map float32 -> int64 in [0, 2^32): a < b iff key(a) <
    key(b) (sign-flip trick, -0.0 canonicalised to +0.0)."""
    x = torch.where(x == 0.0, 0.0, x)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK
    neg = (bits >> 31) == 1
    return torch.where(neg, (~bits) & _MASK, bits | _SIGN)


def ordered_key_to_float(u: torch.Tensor) -> torch.Tensor:
    neg = (u >> 31) == 0
    bits = torch.where(neg, (~u) & _MASK, u & 0x7FFFFFFF)
    # int64 in [0, 2^32) -> the int32 with the same low 32 bits.
    bits = torch.where(bits >= _SIGN, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def lane_layout(x: torch.Tensor, fill) -> torch.Tensor:
    """(O, ...) -> (J, LANES, ...): sample o at [o // LANES, o % LANES],
    the tail padded with `fill` (J = ceil(O / LANES)). Lane s of a pixel
    holds the samples s, s + LANES, s + 2 LANES, ... as in the kernel."""
    O = x.shape[0]
    J = -(-O // LANES)
    if J * LANES != O:
        pad = torch.full((J * LANES - O,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    return x.reshape((J, LANES) + tuple(x.shape[1:]))


def fixed_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the two leading axes (J, LANES) of `a` in the kernel's
    order: each lane adds its samples in position order, then the lanes
    combine in a halving tree (lane s plus lane s + n/2), as the kernel's
    __shfl_xor_sync butterfly does. Every step is one elementwise add, so
    the result depends on neither the device nor the library."""
    p = a[0]
    for j in range(1, a.shape[0]):
        p = p + a[j]
    n = p.shape[0]
    while n > 1:
        n //= 2
        p = p[:n] + p[n:]
    return p[0]


def _median_keys(u: torch.Tensor, w: torch.Tensor,
                 half: torch.Tensor) -> torch.Tensor:
    """The 32-step radix descent over ordered keys u (J, LANES, M, *P)
    with weights w (J, LANES, 1, *P) shared by the M medians: the
    smallest key whose weight at or below it reaches `half` (*P), each
    step's weight below `mid` a `fixed_sum`. Returns (M, *P)."""
    med = torch.zeros(u.shape[2:], dtype=torch.int64, device=u.device)
    for i in range(32):
        mid = med | (1 << (31 - i))
        below = fixed_sum(torch.where(u < mid, w, 0.0))
        med = torch.where(below < half, mid, med)
    return med


def _donor_index(u: torch.Tensor, w: torch.Tensor, med_u: torch.Tensor,
                 half: torch.Tensor, O: int) -> torch.Tensor:
    """The smallest sample index at the median key `med_u` whose running
    weight reaches `half` (the stable-sort tie break), by a descent over
    the index bits; u, w (J, LANES, *P). Clamped to O - 1."""
    J = u.shape[0]
    w_at = torch.where(u == med_u, w, 0.0)
    base = fixed_sum(torch.where(u < med_u, w, 0.0))
    oidx = torch.arange(J * LANES, device=u.device).reshape(
        (J, LANES) + (1,) * (u.dim() - 2))
    nbits = max(1, (O - 1).bit_length())
    med_i = torch.zeros_like(med_u)
    for i in range(nbits):
        mid = med_i | (1 << (nbits - 1 - i))
        below = base + fixed_sum(torch.where(oidx < mid, w_at, 0.0))
        med_i = torch.where(below < half, mid, med_i)
    return torch.clamp(med_i, max=O - 1)


def _weighted_medians(key: torch.Tensor, weight: torch.Tensor):
    """Weighted medians along dim 0 of key (O, M, *P), the M medians
    sharing weight (O, *P): each the smallest key whose cumulative weight
    (in stably sorted order) reaches half the total, and for the first
    the smallest sample index at that key whose running weight reaches
    half (stable-sort tie break). Invalid samples carry weight 0 and key
    +inf. Every weight sum is a `fixed_sum`. Returns ((M, *P) medians,
    (*P) donor index)."""
    u = lane_layout(float_to_ordered_key(key), KEY_INF)
    w = lane_layout(weight, 0.0)
    half = fixed_sum(w) * 0.5
    med_u = _median_keys(u, w[:, :, None], half)
    return ordered_key_to_float(med_u), _donor_index(
        u[:, :, 0], w, med_u[0], half, key.shape[0])


def _weighted_median(key: torch.Tensor, weight: torch.Tensor,
                     with_index: bool = False):
    """The weighted median along dim 0 of key (O, *P) with weight (O, *P)
    and, with `with_index`, its donor index (`_weighted_medians`)."""
    med, donor = _weighted_medians(key[:, None], weight)
    return (med[0], donor) if with_index else med[0]


def spatial_factors(offsets, spatial_div: float,
                    sigma_spatial: float) -> list[float]:
    """exp(-(|offset| / spatial_div) / sigma_spatial^2) per offset, in
    double: the plain version multiplies a float32 tensor by it (torch
    rounds it to float32 first), the kernel takes it as a float32."""
    inv_ss = 1.0 / (sigma_spatial * sigma_spatial)
    return [math.exp(-(math.sqrt(dx * dx + dy * dy) / spatial_div) * inv_ss)
            for dx, dy in offsets]


def _median_plane(gray, disp, normal, reliable, offsets, spatial_div: float,
                  sigma_spatial: float, sigma_color: float) -> _MedianResult:
    """Plain median plane of a block of rows: shifted copies of the five
    fields, the bilateral weights, then the four medians (disparity, nx,
    ny, nz) in one descent and the disparity's donor index."""
    inv_sc = 1.0 / (sigma_color * sigma_color)
    rel_f = reliable.to(torch.float32)
    ws, keys = [], []
    for (dx, dy), sf in zip(offsets, spatial_factors(offsets, spatial_div,
                                                      sigma_spatial)):
        ok = shift_const(rel_f, dy, dx, 0.0) > 0.5
        g = shift_const(gray, dy, dx, 0.0)
        w = sf * torch.exp(-torch.abs(g - gray) * inv_sc)
        ws.append(torch.where(ok, w, 0.0))
        keys.append(torch.stack(
            [shift_const(disp, dy, dx, float("inf"))]
            + [shift_const(normal[..., c], dy, dx, float("inf"))
               for c in range(3)]))
    w = torch.stack(ws)
    valid = w > 0.0
    med, donor = _weighted_medians(
        torch.where(valid[:, None], torch.stack(keys), float("inf")), w)
    return _MedianResult(med_nx=med[1], med_ny=med[2], med_nz=med[3],
                         donor_idx=donor, donor_disp=med[0],
                         num=valid.sum(dim=0))


def _median_plane_plain(gray, disp, normal, reliable, offsets,
                        spatial_div, sigma_spatial, sigma_color,
                        radius: int, chunk_rows: int = 256) -> _MedianResult:
    """The plain version of kernel B4, row-chunked: bounds the (O, rows,
    W) sample stacks. Chunks carry `radius` halo rows padded with the
    out-of-bounds fill values, so the result equals the unchunked one."""
    H, W = gray.shape
    if H <= chunk_rows:
        return _median_plane(gray, disp, normal, reliable, offsets,
                             spatial_div, sigma_spatial, sigma_color)
    pad = radius

    def pad_rows(a, fill):
        out = torch.full((H + 2 * pad,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        out[pad:pad + H] = a
        return out

    g_p = pad_rows(gray, 0.0)
    d_p = pad_rows(disp, float("inf"))
    n_p = pad_rows(normal, float("inf"))
    r_p = pad_rows(reliable, False)
    parts = []
    for start in range(0, H, chunk_rows):
        rows = min(chunk_rows, H - start)
        sl = slice(start, start + rows + 2 * pad)
        res = _median_plane(g_p[sl], d_p[sl], n_p[sl], r_p[sl], offsets,
                            spatial_div, sigma_spatial, sigma_color)
        parts.append([a[pad:pad + rows] for a in res])
    return _MedianResult(*(torch.cat(list(p), dim=0) for p in zip(*parts)))


def median_plane(gray, disp, normal, reliable, offsets, spatial_div,
                 sigma_spatial, sigma_color, radius: int,
                 chunk_rows: int = 256) -> _MedianResult:
    """The weighted median plane of one WMF pass. CUDA tensors launch
    kernel B4 (one launch, no row chunks); CPU tensors run
    `_median_plane_plain` (`chunk_rows` reaches only it)."""
    if not gray.is_cuda:
        return _median_plane_plain(gray, disp, normal, reliable, offsets,
                                   spatial_div, sigma_spatial, sigma_color,
                                   radius, chunk_rows)
    return _MedianResult(*cuda_wmf.median_plane(
        gray, disp, normal, reliable, offsets,
        spatial_factors(offsets, spatial_div, sigma_spatial),
        1.0 / (sigma_color * sigma_color), radius))


def _plane_from_median(med: _MedianResult, offsets, cams: geo.CameraSet):
    """Normalised component-median normal, re-anchored through the donor
    pixel's 3-D point."""
    H, W = med.donor_disp.shape
    dev = med.donor_disp.device
    n = geo.normalize(torch.stack([med.med_nx, med.med_ny, med.med_nz],
                                  dim=-1))
    off = torch.tensor(offsets, dtype=torch.float32, device=dev)
    xx, yy = geo.pixel_grid(H, W, dev)
    px = xx + off[:, 0][med.donor_idx]
    py = yy + off[:, 1][med.donor_idx]
    donor_depth = geo.disparity_depth(cams.f, cams.baseline, med.donor_disp)
    Kinv = cams.K_inv[0]
    rx = Kinv[0, 0] * px + Kinv[0, 1] * py + Kinv[0, 2]
    ry = Kinv[1, 0] * px + Kinv[1, 1] * py + Kinv[1, 2]
    d = -donor_depth * (n[..., 0] * rx + n[..., 1] * ry + n[..., 2])
    return n, d


def _disparity(cams: geo.CameraSet, normal, d):
    H, W = d.shape
    xx, yy = geo.pixel_grid(H, W, d.device)
    return geo.disparity_depth(cams.f, cams.baseline,
                               geo.depth_from_plane(cams, normal, d, xx, yy))


def wmf_mark_outliers(gray: torch.Tensor, normal: torch.Tensor,
                      d: torch.Tensor, disp: torch.Tensor,
                      reliable: torch.Tensor, iteration: int,
                      cams: geo.CameraSet, params: AlgorithmParams,
                      chunk_rows: int = 256) -> torch.Tensor:
    """One marking pass: the new reliability mask. disp is the current
    per-pixel disparity."""
    po = 2 ** iteration
    radius, gap, spatial_div = pass_schedule("mark", iteration)
    offsets = sample_offsets(radius, gap)
    med = median_plane(gray, disp, normal, reliable, offsets, spatial_div,
                       params.wmf_sigma_spatial, params.wmf_sigma_color,
                       radius, chunk_rows)
    n_med, d_med = _plane_from_median(med, offsets, cams)
    keep = (torch.abs(_disparity(cams, n_med, d_med)
                      - _disparity(cams, normal, d))
            <= params.wmf_drift_thr / po)
    return torch.where(med.num > 0, keep, False)


def wmf_fill(gray: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
             disp: torch.Tensor, reliable: torch.Tensor,
             textured: torch.Tensor, iteration: int, cams: geo.CameraSet,
             params: AlgorithmParams, chunk_rows: int = 256):
    """One fill pass: unreliable textured pixels with >= 32/2^i reliable
    samples take the weighted median plane; the fill is reliable when its
    disparity lies in (min_disparity, max_disparity). Returns (normal, d,
    disp, reliable)."""
    po = 2 ** iteration
    radius, gap, spatial_div = pass_schedule("fill", iteration)
    offsets = sample_offsets(radius, gap)
    med = median_plane(gray, disp, normal, reliable, offsets, spatial_div,
                       params.wmf_sigma_spatial, params.wmf_sigma_color,
                       radius, chunk_rows)
    n_med, d_med = _plane_from_median(med, offsets, cams)
    disp_med = _disparity(cams, n_med, d_med)
    fill = textured & ~reliable & (med.num >= 32 // po)
    in_range = ((disp_med > params.min_disparity)
                & (disp_med < params.max_disparity))
    return (torch.where(fill[..., None], n_med, normal),
            torch.where(fill, d_med, d),
            torch.where(fill, torch.where(in_range, disp_med,
                                          params.min_disparity), disp),
            torch.where(fill, in_range, reliable))
