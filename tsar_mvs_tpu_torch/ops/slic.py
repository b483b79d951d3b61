"""SLIC superpixels as iterative k-means on a fixed grid (port of
``tsar_mvs_tpu.ops.slic``, the gSLICr engine): CIELAB features, grid
cluster init, association over the 3x3 neighbouring cells, centre update
by scatter-add, optional connectivity suppression. Distance
sqrt(dcolor^2 + (dxy * coh_weight / spixel_size)^2), colour term
unnormalised. TSAR runs it without connectivity enforcement.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def rgb_to_cielab(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (H, W, 3) in [0, 255] -> CIELAB, with gSLICr's 0.0039216 scale
    and reference white."""
    c = rgb * 0.0039216
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    x = r * 0.412453 + g * 0.357580 + b * 0.180423
    y = r * 0.212671 + g * 0.715160 + b * 0.072169
    z = r * 0.019334 + g * 0.119193 + b * 0.950227
    xr, yr, zr = x / 0.950456, y / 1.0, z / 1.088754
    eps, kappa = 0.008856, 903.3

    def f(t):
        return torch.where(t > eps, torch.pow(t, 1.0 / 3.0),
                           (kappa * t + 16.0) / 116.0)

    fx, fy, fz = f(xr), f(yr), f(zr)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def gray_to_feature(gray: torch.Tensor) -> torch.Tensor:
    """Grayscale (H, W) in [0, 255] -> replicated-RGB CIELAB feature."""
    return rgb_to_cielab(torch.stack([gray] * 3, dim=-1))


class SlicResult(NamedTuple):
    labels: torch.Tensor         # (H, W) int64 superpixel index
    centers_xy: torch.Tensor     # (M, 2)
    centers_color: torch.Tensor  # (M, 3)
    counts: torch.Tensor         # (M,)
    map_size: tuple[int, int]


def slic(feature: torch.Tensor, spixel_size: int = 20,
         coh_weight: float = 5.0, n_iters: int = 5,
         enforce_connectivity: bool = False) -> SlicResult:
    """Segment a feature image (H, W, 3) into ~(H/S)*(W/S) superpixels;
    `enforce_connectivity` runs two passes of suppress_local_label over
    the labels."""
    H, W = feature.shape[:2]
    dev = feature.device
    S = spixel_size
    map_w = (W + S - 1) // S
    map_h = (H + S - 1) // S
    M = map_h * map_w
    gx = torch.arange(map_w, device=dev) * S + S // 2
    gy = torch.arange(map_h, device=dev) * S + S // 2
    gx = torch.where(gx >= W, (torch.arange(map_w, device=dev) * S + W) // 2,
                     gx)
    gy = torch.where(gy >= H, (torch.arange(map_h, device=dev) * S + H) // 2,
                     gy)
    cy0, cx0 = torch.meshgrid(gy, gx, indexing="ij")
    centers_xy = torch.stack([cx0, cy0], dim=-1).reshape(M, 2).to(
        torch.float32)
    centers_color = feature[cy0.reshape(-1), cx0.reshape(-1)]

    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cell_x = (torch.arange(W, device=dev) // S)[None, :]
    cell_y = (torch.arange(H, device=dev) // S)[:, None]
    norm_xy = coh_weight / float(S)
    flat_feat = feature.reshape(H * W, 3)
    xs_flat = xx.expand(H, W).reshape(-1)
    ys_flat = yy.expand(H, W).reshape(-1)

    def associate(cxy, ccol):
        best = torch.full((H, W), float("inf"), device=dev)
        label = torch.zeros((H, W), dtype=torch.int64, device=dev)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                nx = cell_x + di
                ny = cell_y + dj
                ok = (nx >= 0) & (nx < map_w) & (ny >= 0) & (ny < map_h)
                idx = (torch.clamp(ny, 0, map_h - 1) * map_w
                       + torch.clamp(nx, 0, map_w - 1)).expand(H, W)
                col = ccol[idx]
                pos = cxy[idx]
                dc2 = torch.sum((feature - col) ** 2, dim=-1)
                dxy2 = (xx - pos[..., 0]) ** 2 + (yy - pos[..., 1]) ** 2
                dist = torch.where(ok, dc2 + dxy2 * (norm_xy * norm_xy),
                                   float("inf"))
                take = dist < best
                best = torch.where(take, dist, best)
                label = torch.where(take, idx, label)
        return label

    def update(label):
        flat = label.reshape(-1)
        zeros = torch.zeros(M, dtype=torch.float32, device=dev)
        cnt = zeros.index_add(0, flat, torch.ones_like(xs_flat))
        sx = zeros.index_add(0, flat, xs_flat)
        sy = zeros.index_add(0, flat, ys_flat)
        scol = torch.zeros((M, 3), dtype=torch.float32,
                           device=dev).index_add(0, flat, flat_feat)
        safe = torch.clamp(cnt, min=1.0)
        return (torch.stack([sx / safe, sy / safe], dim=-1),
                scol / safe[:, None], cnt)

    label = associate(centers_xy, centers_color)
    counts = None
    for _ in range(n_iters):
        centers_xy, centers_color, counts = update(label)
        label = associate(centers_xy, centers_color)
    if counts is None:
        _, _, counts = update(label)
    if enforce_connectivity:
        label = suppress_local_label(suppress_local_label(label))
    return SlicResult(labels=label, centers_xy=centers_xy,
                      centers_color=centers_color, counts=counts,
                      map_size=(map_h, map_w))


def suppress_local_label(label: torch.Tensor) -> torch.Tensor:
    """Connectivity suppression (gSLICr's supress_local_lable): a pixel
    with 16 or more of its 5x5 neighbours (wrapping round at the image
    edges) under another label takes the last such label in scan order,
    rows outer and columns inner. A 2-pixel border keeps its labels."""
    H, W = label.shape
    diff_count = torch.zeros((H, W), dtype=torch.int32, device=label.device)
    diff_label = torch.full_like(label, -1)
    for dj in range(-2, 3):
        for di in range(-2, 3):
            n = torch.roll(label, shifts=(-dj, -di), dims=(0, 1))
            differs = n != label
            diff_count += differs.to(torch.int32)
            diff_label = torch.where(differs, n, diff_label)
    out = torch.where(diff_count >= 16, diff_label, label)
    out[:2] = label[:2]
    out[-2:] = label[-2:]
    out[:, :2] = label[:, :2]
    out[:, -2:] = label[:, -2:]
    return out


def superpixel_graph_host(labels) -> tuple[dict[int, set[int]],
                                           dict[int, int],
                                           dict[tuple[int, int], int]]:
    """Superpixel adjacency, membership sizes and shared-border lengths
    keyed by (min_label, max_label), built on the host from the labels."""
    lab = np.asarray(labels)
    sizes_u, counts_u = np.unique(lab, return_counts=True)
    sizes = dict(zip(sizes_u.tolist(), counts_u.tolist()))
    adjacency: dict[int, set[int]] = {int(k): set() for k in sizes_u}
    borders: dict[tuple[int, int], int] = {}
    for a, b in ((lab[:, :-1], lab[:, 1:]), (lab[:-1, :], lab[1:, :])):
        diff = a != b
        for x, y in zip(a[diff].tolist(), b[diff].tolist()):
            lo, hi = (x, y) if x < y else (y, x)
            adjacency[x].add(y)
            adjacency[y].add(x)
            borders[(lo, hi)] = borders.get((lo, hi), 0) + 1
    return adjacency, sizes, borders
