"""Weighted median filters over the plane field (port of
``tsar_mvs_tpu.ops.wmf``).

* ``wmf_mark_outliers``: coarse-to-fine passes (radius 80/2^i, gap
  16/2^i) computing the bilateral weighted median plane of reliable
  neighbours; a pixel becomes unreliable when the median plane's
  disparity drifts more than wmf_drift_thr/2^i from its own.
* ``wmf_fill``: fine passes (radius 5*2^i, gap 2^i) filling unreliable
  textured pixels with the weighted median plane when at least 32/2^i
  reliable samples exist.

The weighted median is a radix bit descent over an order-preserving
integer image of the keys, with the donor sample recovered by a second
descent over the tied keys. Keys are int64 holding the uint32 image
(torch's uint32 lacks most ops); the order is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.ops.checkerboard import shift_const

_SIGN = 0x80000000
_MASK = 0xFFFFFFFF


def sample_offsets(radius: int, gap: int) -> list[tuple[int, int]]:
    """(dx, dy) grid: i, j in [-radius, radius] step gap."""
    rng = list(range(-radius, radius + 1, gap))
    return [(i, j) for i in rng for j in rng]


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


def _weighted_median(key: torch.Tensor, weight: torch.Tensor,
                     with_index: bool = False):
    """Weighted median along dim 0: the smallest key whose cumulative
    weight (in stably sorted order) reaches half the total. Invalid
    samples carry weight 0 and key +inf. With `with_index`, also the
    smallest sample index at that key whose running weight reaches half
    (stable-sort tie break)."""
    u = float_to_ordered_key(key)
    half = torch.sum(weight, dim=0) * 0.5
    med_u = torch.zeros_like(u[0])
    for i in range(32):
        mid = med_u | (1 << (31 - i))
        below = torch.sum(torch.where(u < mid[None], weight, 0.0), dim=0)
        med_u = torch.where(below < half, mid, med_u)
    med = ordered_key_to_float(med_u)
    if not with_index:
        return med
    w_at = torch.where(u == med_u[None], weight, 0.0)
    base = torch.sum(torch.where(u < med_u[None], weight, 0.0), dim=0)
    O = key.shape[0]
    oidx = torch.arange(O, device=key.device).view(
        (O,) + (1,) * (key.dim() - 1))
    nbits = max(1, (O - 1).bit_length())
    med_i = torch.zeros_like(med_u)
    for i in range(nbits):
        mid = med_i | (1 << (nbits - 1 - i))
        below = base + torch.sum(torch.where(oidx < mid[None], w_at, 0.0),
                                 dim=0)
        med_i = torch.where(below < half, mid, med_i)
    return med, torch.clamp(med_i, max=O - 1)


def _median_plane(gray, disp, normal, reliable, offsets, spatial_div: float,
                  sigma_spatial: float, sigma_color: float) -> _MedianResult:
    inv_ss = 1.0 / (sigma_spatial * sigma_spatial)
    inv_sc = 1.0 / (sigma_color * sigma_color)
    rel_f = reliable.to(torch.float32)
    ws, ds, nxs, nys, nzs = [], [], [], [], []
    for (dx, dy) in offsets:
        ok = shift_const(rel_f, dy, dx, 0.0) > 0.5
        g = shift_const(gray, dy, dx, 0.0)
        spatial = math.sqrt(dx * dx + dy * dy) / spatial_div
        w = math.exp(-spatial * inv_ss) * torch.exp(
            -torch.abs(g - gray) * inv_sc)
        ws.append(torch.where(ok, w, 0.0))
        ds.append(shift_const(disp, dy, dx, float("inf")))
        nxs.append(shift_const(normal[..., 0], dy, dx, float("inf")))
        nys.append(shift_const(normal[..., 1], dy, dx, float("inf")))
        nzs.append(shift_const(normal[..., 2], dy, dx, float("inf")))
    w = torch.stack(ws)
    valid = w > 0.0
    num = valid.sum(dim=0)
    inf = float("inf")
    med_d, donor = _weighted_median(
        torch.where(valid, torch.stack(ds), inf), w, with_index=True)
    return _MedianResult(
        med_nx=_weighted_median(torch.where(valid, torch.stack(nxs), inf), w),
        med_ny=_weighted_median(torch.where(valid, torch.stack(nys), inf), w),
        med_nz=_weighted_median(torch.where(valid, torch.stack(nzs), inf), w),
        donor_idx=donor, donor_disp=med_d, num=num)


def _median_plane_chunked(gray, disp, normal, reliable, offsets,
                          spatial_div, sigma_spatial, sigma_color,
                          radius: int, chunk_rows: int) -> _MedianResult:
    """Row-chunked median: bounds the (O, rows, W) sample stacks. Chunks
    carry `radius` halo rows padded with the out-of-bounds fill values, so
    the result equals the unchunked one."""
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
    radius, gap = 80 // po, 16 // po
    offsets = sample_offsets(radius, gap)
    med = _median_plane_chunked(gray, disp, normal, reliable, offsets,
                                float(2 ** (3 - iteration)),
                                params.wmf_sigma_spatial,
                                params.wmf_sigma_color, radius, chunk_rows)
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
    radius, gap = 5 * po, po
    offsets = sample_offsets(radius, gap)
    med = _median_plane_chunked(gray, disp, normal, reliable, offsets,
                                float(po), params.wmf_sigma_spatial,
                                params.wmf_sigma_color, radius, chunk_rows)
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
