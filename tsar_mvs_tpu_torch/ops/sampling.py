"""Image sampling primitives (port of ``tsar_mvs_tpu.ops.sampling``).

Bilinear sampling with clamp-to-edge addressing, the equivalent of the
reference's texture reads at `(x + 0.5, y + 0.5)`: integer coordinates
return the exact pixel. Interpolation runs in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def shift_with_edge_clamp(img: torch.Tensor, dy: int,
                          dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., clamp(y+dy), clamp(x+dx)]."""
    H, W = img.shape[-2], img.shape[-1]
    iy = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    ix = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img.index_select(-2, iy).index_select(-1, ix)


class PackedImage(NamedTuple):
    """Source image with its 4 bilinear corners packed per pixel:
    data[y*W + x] = (I[y,x], I[y,x+1], I[y+1,x], I[y+1,x+1]), edge-clamped."""

    data: torch.Tensor   # (H*W, 4)
    height: int
    width: int


def pack_image(img: torch.Tensor, dtype=None) -> PackedImage:
    """Pack a (H, W) image; dtype=torch.bfloat16 rounds the corners the
    way the s-volume build reads them (8-bit intensities are exact)."""
    H, W = img.shape
    data = torch.stack([img, shift_with_edge_clamp(img, 0, 1),
                        shift_with_edge_clamp(img, 1, 0),
                        shift_with_edge_clamp(img, 1, 1)],
                       dim=-1).reshape(H * W, 4)
    if dtype is not None:
        data = data.to(dtype)
    return PackedImage(data=data, height=H, width=W)


def _clamp_coords(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Clamp to the image box. A NaN coordinate (a degenerate warp) reads
    pixel 0 instead of indexing out of bounds."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, W - 1.0)
    y = torch.clamp(torch.nan_to_num(y, nan=0.0), 0.0, H - 1.0)
    return x, y


def _corner_weights(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    x, y = _clamp_coords(x, y, H, W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    idx = y0.to(torch.int64) * W + x0.to(torch.int64)
    return idx, x - x0, y - y0


def _lerp4(v: torch.Tensor, fx: torch.Tensor,
           fy: torch.Tensor) -> torch.Tensor:
    top = v[..., 0] + (v[..., 1] - v[..., 0]) * fx
    bot = v[..., 2] + (v[..., 3] - v[..., 2]) * fx
    return top + (bot - top) * fy


def bilinear_sample_packed(packed: PackedImage, x: torch.Tensor,
                           y: torch.Tensor,
                           base: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear, clamp-to-edge sample of a PackedImage at float coords.
    `base` offsets each row index (stacked images: view * H * W)."""
    idx, fx, fy = _corner_weights(x, y, packed.height, packed.width)
    if base is not None:
        idx = idx + base
    v = packed.data[idx].to(torch.float32)
    return _lerp4(v, fx, fy)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at float coords (x, y), bilinear, clamp-to-edge."""
    H, W = img.shape[-2], img.shape[-1]
    x, y = _clamp_coords(x, y, H, W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = img.reshape(H * W)
    v = torch.stack([flat[y0i * W + x0i], flat[y0i * W + x1i],
                     flat[y1i * W + x0i], flat[y1i * W + x1i]], dim=-1)
    return _lerp4(v, fx, fy)
