"""Red/black checkerboard candidate selection and parity packing (port of
``tsar_mvs_tpu.ops.checkerboard``).

Eight candidate banks per pixel (4 "far" combs of 11 samples spaced 2, 4
"near" V-shapes of 7): each bank's running min over the stored cost,
carrying the plane components along. The red/black halves are parity
classes {(y, x): (x + y) % 2 == p}, packed densely into (H, W/2).

The reference's two candidate-selection bugs stay fixed exactly as the
JAX package fixes them (down_far initialises from its own first sample;
right_far selects the min).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def shift_const(arr: torch.Tensor, dy: int, dx: int,
                fill) -> torch.Tensor:
    """out[..., y, x] = arr[..., y+dy, x+dx] where in bounds, else `fill`."""
    H, W = arr.shape[-2], arr.shape[-1]
    out = torch.full_like(arr, fill)
    ys, ye = max(0, -dy), min(H, H - dy)
    xs, xe = max(0, -dx), min(W, W - dx)
    if ys < ye and xs < xe:
        out[..., ys:ye, xs:xe] = arr[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def _far_bank(axis: str, sign: int) -> list[tuple[int, int]]:
    return [((sign * (3 + 2 * i), 0) if axis == "x" else
             (0, sign * (3 + 2 * i))) for i in range(11)]


def _near_bank(axis: str, sign: int) -> list[tuple[int, int]]:
    out = [(0, sign * 1)] if axis == "y" else [(sign * 1, 0)]
    for i in range(3):
        if axis == "y":
            out.append((-i, sign * (2 + i)))
            if i > 0:
                out.append((i, sign * (2 + i)))
        else:
            out.append((sign * (2 + i), -i))
            if i > 0:
                out.append((sign * (2 + i), i))
    return out


# (dx, dy) per candidate; far combs first, near V-shapes last.
BANKS: tuple[tuple[tuple[int, int], ...], ...] = (
    tuple(_far_bank("y", -1)),   # up_far
    tuple(_far_bank("y", +1)),   # down_far
    tuple(_far_bank("x", -1)),   # left_far
    tuple(_far_bank("x", +1)),   # right_far
    tuple(_near_bank("y", -1)),  # up_near
    tuple(_near_bank("y", +1)),  # down_near
    tuple(_near_bank("x", -1)),  # left_near
    tuple(_near_bank("x", +1)),  # right_near
)


class Candidates(NamedTuple):
    """One candidate plane per bank and pixel."""
    normal: torch.Tensor   # (B, H, W, 3)
    d: torch.Tensor        # (B, H, W)
    valid: torch.Tensor    # (B, H, W) bool: the bank had an in-bounds sample


def select_candidates(normal: torch.Tensor, d: torch.Tensor,
                      cost: torch.Tensor, banks=BANKS) -> Candidates:
    """Per bank of `banks`, the plane of the stored-cost argmin sample.
    normal: (H, W, 3); d, cost: (H, W). Out-of-bounds samples carry cost
    +inf and a zero plane (d = 0)."""
    comps = torch.stack([normal[..., 0], normal[..., 1], normal[..., 2], d])
    out_n, out_d, out_valid = [], [], []
    for bank in banks:
        best_c = best = None
        for (dx, dy) in bank:
            c_s = shift_const(cost, dy, dx, float("inf"))
            vals = shift_const(comps, dy, dx, 0.0)
            if best_c is None:
                best_c, best = c_s, vals
            else:
                take = c_s < best_c
                best_c = torch.where(take, c_s, best_c)
                best = torch.where(take, vals, best)
        out_valid.append(torch.isfinite(best_c))
        out_n.append(best[:3].permute(1, 2, 0))
        out_d.append(best[3])
    return Candidates(normal=torch.stack(out_n), d=torch.stack(out_d),
                      valid=torch.stack(out_valid))


def parity_mask(height: int, width: int, parity: int,
                device=None) -> torch.Tensor:
    """True where (x + y) % 2 == parity (black = 0, red = 1)."""
    yy = torch.arange(height, device=device)[:, None]
    xx = torch.arange(width, device=device)[None, :]
    return ((xx + yy) % 2) == parity


# ---------------------------------------------------------------------------
# Parity half-grid packing: row y of a parity class holds the columns
# x = 2j + (p + y) % 2. Requires H and W even.
# ---------------------------------------------------------------------------

def parity_compressible(height: int, width: int) -> bool:
    return height % 2 == 0 and width % 2 == 0


def parity_coords(height: int, width: int, parity: int, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xx, yy) float32 dense coordinates of the packed layout, each
    (H, W/2)."""
    rows = torch.arange(height, device=device)
    yy = rows.to(torch.float32)[:, None].expand(height, width // 2)
    off = (parity + rows) % 2
    xx = (2 * torch.arange(width // 2, device=device)[None, :]
          + off[:, None]).to(torch.float32)
    return xx, yy


def parity_compress(a: torch.Tensor, parity: int) -> torch.Tensor:
    """(..., H, W) -> (..., H, W/2): keep only the parity class."""
    H, W = a.shape[-2], a.shape[-1]
    even = a[..., 0::2, parity::2]
    odd = a[..., 1::2, (1 - parity)::2]
    return torch.stack([even, odd], dim=-2).reshape(*a.shape[:-2], H,
                                                    W // 2)


def parity_expand(comp: torch.Tensor, old: torch.Tensor,
                  parity: int) -> torch.Tensor:
    """Scatter packed values back: the parity class takes `comp`, the
    other pixels keep `old`. comp: (..., H, W/2); old: (..., H, W)."""
    out = old.clone()
    out[..., 0::2, parity::2] = comp[..., 0::2, :]
    out[..., 1::2, (1 - parity)::2] = comp[..., 1::2, :]
    return out


def parity_compress_vec(a: torch.Tensor, parity: int) -> torch.Tensor:
    """Channel-last variant: (..., H, W, C) -> (..., H, W/2, C)."""
    return parity_compress(a.movedim(-1, 0), parity).movedim(0, -1)


def parity_expand_vec(comp: torch.Tensor, old: torch.Tensor,
                      parity: int) -> torch.Tensor:
    """Channel-last variant of parity_expand."""
    return parity_expand(comp.movedim(-1, 0), old.movedim(-1, 0),
                         parity).movedim(0, -1)
