"""PatchMatch's checkerboard half-pass around the cost kernel: candidate
selection, the refine proposals and the accepts (kernel B6 on the card,
``ops/cuda_halfpass.py``; the plain versions here on the CPU).

A propagation half-pass is `prop_select` (each bank's stored-cost argmin
sample and the candidates' plane scalars), the cost kernel (B1 or B3) on
those scalars, and `prop_accept` (the depth range check and the
sequential accept over the banks). A refine scale is two draws
(`draw_refine`: `torch.rand` of the grid and of its normals, in that
order), `refine_propose`, the cost kernel and `refine_accept`. The
accepts write the winners into the parity's pixels of the full state in
place. The grid is the packed (H, W/2) parity class (`Grid.packed`) or,
with an odd side, the dense (H, W) grid, whose accepts update the
parity's pixels only.

Each dispatcher launches B6 on CUDA tensors and runs the plain version
on CPU tensors. The plain versions compute exactly what the kernels do,
in their rounding order: 3-term sums written out as (a0 b0 + a1 b1) +
a2 b2, the normalisation as v * (1 / sqrt(|v|^2 + eps)) with a correctly
rounded root (torch.rsqrt is not correctly rounded on the card, nor
float32 sqrt on every CPU), every step a torch op of its own, so the
kernel equals its plain version to the bit. ``PLAIN_CALLS`` counts
the plain versions' calls (read by chip_smoke.py: 0 on the card's main
path).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import cuda_halfpass

# Calls of the plain versions since the last reset, by function.
PLAIN_CALLS = 0

# normalize's epsilon (geo.normalize).
EPS = 1e-20


class Grid(NamedTuple):
    """The updating grid of one level's half-passes: per parity the rays
    and unit view vectors at its positions ((Hc, Wc, 3), contiguous) and
    its dense coordinates (xx, yy); `consts` (13,) f32 on the device: f,
    baseline, cx, cy, alpha, depth_min, depth_max, K^-1's first two
    columns (the plane scalars' k0 and k1)."""
    packed: bool
    rays: tuple
    vv: tuple
    coords: tuple
    consts: torch.Tensor


class Candidates(NamedTuple):
    """Per bank and grid position: the candidate plane, its valid flag and
    its plane scalars (B, Hc, Wc[, 3])."""
    normal: torch.Tensor
    d: torch.Tensor
    valid: torch.Tensor
    s0: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor


class Proposal(NamedTuple):
    """One refine scale's planes and their plane scalars (Hc, Wc[, 3])."""
    normal: torch.Tensor
    d: torch.Tensor
    s0: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor


def make_grid(cams: geo.CameraSet, height: int, width: int,
              pctx=None, rays: torch.Tensor | None = None) -> Grid:
    """The Grid of a level: from the packed passes' ParityCtx `pctx`, or
    the dense grid (odd sides) with `rays` (default geo.pixel_rays)."""
    k = cams.K_inv[0]
    consts = torch.stack([cams.f, cams.baseline, cams.cx, cams.cy,
                          cams.alpha, cams.depth_min, cams.depth_max,
                          k[0, 0], k[1, 0], k[2, 0], k[0, 1], k[1, 1],
                          k[2, 1]]).to(torch.float32).contiguous()
    if pctx is not None:
        return Grid(packed=True,
                    rays=tuple(r.contiguous() for r in pctx.rays),
                    vv=tuple(v.contiguous() for v in pctx.vv),
                    coords=tuple(pctx.coords), consts=consts)
    if rays is None:
        rays = geo.pixel_rays(cams, height, width)
    rays = rays.contiguous()
    vv = geo.view_vectors(cams, height, width).contiguous()
    xy = geo.pixel_grid(height, width, cams.device)
    return Grid(packed=False, rays=(rays, rays), vv=(vv, vv),
                coords=(xy, xy), consts=consts)


def grid_shape(grid: Grid, height: int, width: int) -> tuple[int, int]:
    return (height, width // 2) if grid.packed else (height, width)


def draw_refine(generator: torch.Generator, shape: tuple[int, int],
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """One refine scale's draws: u (Hc, Wc) for the disparity step, then r
    (Hc, Wc, 3) for the normal's, each uniform in [0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    r = torch.rand(shape + (3,), generator=generator, device=device)
    return u, r


def refine_draws(generator: torch.Generator, grid: Grid, state, n: int):
    """A refinement half-pass's `n` scales' draws (draw_refine at the
    grid's shape), each made only when the pass asks for it."""
    shape = grid_shape(grid, *state.d.shape)
    return (draw_refine(generator, shape, state.d.device) for _ in range(n))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a1 b1) + a2 b2 over the last axis (the kernel's order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[
        ..., 2]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the kernel's
    __fsqrt_rn): taken in float64 and rounded, which is exact for a root
    (53 >= 2 * 24 + 2 bits). torch's float32 sqrt is not correctly
    rounded on every CPU."""
    return torch.sqrt(x.double()).float()


def _scalars(normal, d, rays, consts):
    """(s0, sx, sy) = (n·ray, n·k0, n·k1) * (1 / d)."""
    inv_d = torch.reciprocal(d)
    return (_dot3(normal, rays) * inv_d, _dot3(normal, consts[7:10]) * inv_d,
            _dot3(normal, consts[10:13]) * inv_d)


def _gather(state, parity: int, packed: bool):
    """The state at the grid's positions: compressed (packed) or itself."""
    if not packed:
        return state
    return type(state)(
        normal=cb.parity_compress_vec(state.normal, parity),
        d=cb.parity_compress(state.d, parity),
        cost=cb.parity_compress(state.cost, parity),
        ratio=cb.parity_compress(state.ratio, parity),
        best_view=cb.parity_compress(state.best_view, parity))


def _scatter(state, parity: int, packed: bool, take: torch.Tensor, new):
    """Write `new`'s fields (grid layout) into `state` in place where
    `take` (grid layout) holds."""
    H, W = state.d.shape
    if packed:
        take = cb.parity_expand(take, torch.zeros((H, W), dtype=torch.bool,
                                                  device=take.device),
                                parity)
        new = type(state)(
            normal=cb.parity_expand_vec(new.normal, state.normal, parity),
            d=cb.parity_expand(new.d, state.d, parity),
            cost=cb.parity_expand(new.cost, state.cost, parity),
            ratio=cb.parity_expand(new.ratio, state.ratio, parity),
            best_view=cb.parity_expand(new.best_view, state.best_view,
                                       parity))
    else:
        take = take & cb.parity_mask(H, W, parity, take.device)
    for old, val in zip(state, new):
        mask = take[..., None] if old.dim() == 3 else take
        old.copy_(torch.where(mask, val, old))


def prop_select_plain(state, parity: int, banks, grid: Grid) -> Candidates:
    """Plain version of kernel B6's prop_select: cb.select_candidates over
    `banks` at the grid's positions, with the candidates' plane scalars."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cands = cb.select_candidates(state.normal, state.d, state.cost, banks)
    n, d, valid = cands.normal, cands.d, cands.valid
    if grid.packed:
        n = cb.parity_compress_vec(n, parity)
        d = cb.parity_compress(d, parity)
        valid = cb.parity_compress(valid, parity)
    s0, sx, sy = _scalars(n, d, grid.rays[parity], grid.consts)
    return Candidates(normal=n.contiguous(), d=d.contiguous(), valid=valid,
                      s0=s0, sx=sx, sy=sy)


def _depth(normal, d, xx, yy, consts):
    """geo.depth_from_plane on the consts: (-d f) / ((n0 (x - cx) + n1
    (y - cy) alpha) + n2 f)."""
    f, cx, cy, alpha = consts[0], consts[2], consts[3], consts[4]
    denom = (normal[..., 0] * (xx - cx) + normal[..., 1] * (yy - cy) * alpha
             + normal[..., 2] * f)
    return -d * f / denom


def prop_accept_plain(state, parity: int, cands: Candidates, mv,
                      grid: Grid) -> None:
    """Plain version of kernel B6's prop_accept: the candidates in the
    depth range keep their cost (else +inf); the banks accept in order,
    each strictly below the running best (from the stored cost); the
    winners go into `state` in place."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    xx, yy = grid.coords[parity]
    c = grid.consts
    depth = _depth(cands.normal, cands.d, xx, yy, c)
    ok = cands.valid & (depth >= c[5]) & (depth <= c[6])
    cand_cost = torch.where(ok, mv.cost, float("inf"))
    cur = _gather(state, parity, grid.packed)
    best_cost = cur.cost
    take = torch.zeros(best_cost.shape, dtype=torch.bool,
                       device=best_cost.device)
    best = [cur.normal, cur.d, cur.ratio, cur.best_view]
    for k in range(cands.d.shape[0]):
        t = cand_cost[k] < best_cost
        best_cost = torch.where(t, cand_cost[k], best_cost)
        best = [torch.where(t[..., None], cands.normal[k], best[0]),
                torch.where(t, cands.d[k], best[1]),
                torch.where(t, mv.ratio[k], best[2]),
                torch.where(t, mv.best_view[k], best[3])]
        take = take | t
    _scatter(state, parity, grid.packed, take, type(state)(
        normal=best[0], d=best[1], cost=best_cost, ratio=best[2],
        best_view=best[3]))


def refine_propose_plain(state, parity: int, grid: Grid, u: torch.Tensor,
                         r: torch.Tensor, min_disp: float, max_disp: float,
                         delta_z: float, delta_n: float) -> Proposal:
    """Plain version of kernel B6's refine_propose: from the state's plane
    at each grid position and the draws u (Hc, Wc), r (Hc, Wc, 3), the
    disparity step clamped to +-delta_z and to [min_disp, max_disp], the
    perturbed normal n + (2 delta_n r - delta_n), normalised and turned
    to face the camera, the plane through the new depth, and its plane
    scalars."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cur = _gather(state, parity, grid.packed)
    xx, yy = grid.coords[parity]
    c = grid.consts
    fb = c[0] * c[1]
    disp_now = fb / _depth(cur.normal, cur.d, xx, yy, c)
    min_delta = -torch.clamp(min_disp + disp_now, max=delta_z)
    max_delta = torch.clamp(max_disp - disp_now, max=delta_z)
    dz = min_delta + u * (max_delta - min_delta)
    disp_new = torch.clamp(disp_now + dz, min_disp, max_disp)
    depth_new = fb / disp_new
    v = cur.normal + (-delta_n + 2.0 * delta_n * r)
    inv = torch.reciprocal(_sqrt_rn(_dot3(v, v) + EPS))
    n_new = v * inv[..., None]
    n_new = torch.where((_dot3(n_new, grid.vv[parity]) > 0.0)[..., None],
                        -n_new, n_new)
    nr = _dot3(n_new, grid.rays[parity])
    d_new = -depth_new * nr
    inv_d = torch.reciprocal(d_new)
    return Proposal(normal=n_new, d=d_new, s0=nr * inv_d,
                    sx=_dot3(n_new, c[7:10]) * inv_d,
                    sy=_dot3(n_new, c[10:13]) * inv_d)


def refine_accept_plain(state, parity: int, grid: Grid, prop: Proposal,
                        mv) -> None:
    """Plain version of kernel B6's refine_accept: where the proposal's
    cost is strictly below the stored one (dense grid: and at the
    parity's pixels), it replaces the state's plane, cost, ratio and best
    view, in place."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cur = _gather(state, parity, grid.packed)
    _scatter(state, parity, grid.packed, mv.cost < cur.cost, type(state)(
        normal=prop.normal, d=prop.d, cost=mv.cost, ratio=mv.ratio,
        best_view=mv.best_view))


def prop_select(state, parity: int, banks, grid: Grid) -> Candidates:
    if not state.d.is_cuda:
        return prop_select_plain(state, parity, banks, grid)
    return Candidates(*cuda_halfpass.prop_select(
        state.normal, state.d, state.cost, parity, grid.packed,
        grid.rays[parity], grid.consts, banks))


def prop_accept(state, parity: int, cands: Candidates, mv,
                grid: Grid) -> None:
    if not state.d.is_cuda:
        return prop_accept_plain(state, parity, cands, mv, grid)
    cuda_halfpass.prop_accept(state, parity, grid.packed, cands.normal,
                              cands.d, cands.valid, mv, grid.consts)


def refine_propose(state, parity: int, grid: Grid, u, r, min_disp: float,
                   max_disp: float, delta_z: float,
                   delta_n: float) -> Proposal:
    if not state.d.is_cuda:
        return refine_propose_plain(state, parity, grid, u, r, min_disp,
                                    max_disp, delta_z, delta_n)
    return Proposal(*cuda_halfpass.refine_propose(
        state.normal, state.d, parity, grid.packed, grid.rays[parity],
        grid.vv[parity], u, r, grid.consts, min_disp, max_disp, delta_z,
        delta_n, EPS))


def refine_accept(state, parity: int, grid: Grid, prop: Proposal,
                  mv) -> None:
    if not state.d.is_cuda:
        return refine_accept_plain(state, parity, grid, prop, mv)
    cuda_halfpass.refine_accept(state, parity, grid.packed, prop.normal,
                                prop.d, mv)


def propagation(state, parity: int, banks, grid: Grid, cost_fn,
                plain: bool = False) -> None:
    """One propagation half-pass on `state` in place: prop_select, the
    cost of the candidates on their plane scalars (cost_fn(normal, d,
    parity, scalars=...), parity None on the dense grid), prop_accept.
    `plain` runs the plain versions whatever the device (to hold the
    kernels to them on the card)."""
    select, accept = ((prop_select_plain, prop_accept_plain) if plain
                      else (prop_select, prop_accept))
    cands = select(state, parity, banks, grid)
    mv = cost_fn(cands.normal, cands.d, parity if grid.packed else None,
                 scalars=(cands.s0, cands.sx, cands.sy))
    accept(state, parity, cands, mv, grid)


def refinement(state, parity: int, grid: Grid, cost_fn, sched, draws,
               min_disp: float, max_disp: float,
               plain: bool = False) -> None:
    """One refinement half-pass on `state` in place: per (delta_z,
    delta_n) of `sched` the next (u, r) of `draws` (an iterable, consumed
    just before each scale's proposal), refine_propose, the cost,
    refine_accept. `plain` as in `propagation`."""
    propose, accept = ((refine_propose_plain, refine_accept_plain) if plain
                       else (refine_propose, refine_accept))
    for (delta_z, delta_n), (u, r) in zip(sched, draws):
        prop = propose(state, parity, grid, u, r, min_disp, max_disp,
                       delta_z, delta_n)
        mv = cost_fn(prop.normal, prop.d, parity if grid.packed else None,
                     scalars=(prop.s0, prop.sx, prop.sy))
        accept(state, parity, grid, prop, mv)
