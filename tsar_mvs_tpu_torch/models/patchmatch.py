"""Checkerboard PatchMatch MVS engine (port of
``tsar_mvs_tpu.models.patchmatch``).

Red/black propagation over 8 candidate banks plus per-pixel random plane
refinement, evaluated with the bilateral-NCC multi-view cost, on a
coarse-to-fine pyramid. Two samplers give the cost (`resolve_ncc_impl`):
the epipolar s-volume (kernel B2 builds the volumes, kernel B1 evaluates)
and the direct sampler (kernel B3), which also serves `n_best > 1` and
`-color_processing`; the CPU runs their plain versions. Passes run in the
checkerboard-packed (H, W/2) layout when H and W are even; otherwise (an
odd-sided pyramid level) they evaluate on the dense grid and update only
the parity's pixels, as the JAX package does.
The work around the cost of a half-pass (candidate selection, the
refine proposals and the accepts) is kernel B6 on the card and its plain
version on the CPU (``ops/halfpass.py``); it updates the state in place,
and `_iterate` does so on its own copy of a lifted state.

``run_patchmatch_many`` runs a batch of reference views from a SceneBatch
of per-slot warp factors (the unit of the view-sharded scene,
``parallel/``).

Randomness comes from an explicit ``torch.Generator``; the draws are
per pixel at every refine scale (the JAX package's tile-blocked draws
only narrowed its TPU kernel's per-tile brackets, which kernel B1 does
not walk).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import cuda_direct, ncc, ncc_color
from tsar_mvs_tpu_torch.ops import halfpass as hp
from tsar_mvs_tpu_torch.ops import svolume as sv

NCC_IMPLS = ("auto", "svolume", "direct")


def resolve_ncc_impl(params: AlgorithmParams) -> str:
    """The sampler of the PatchMatch cost: an explicit `ncc_impl` wins;
    "auto" takes the s-volume (kernels B1 and B2) for the scripts' n_best
    = 1 operating point and the direct sampler (kernel B3) for n_best > 1,
    the JAX package's rule on an accelerator. The CPU follows the same
    rule: it runs the plain versions of the card's kernels."""
    if params.ncc_impl not in NCC_IMPLS:
        raise ValueError(f"ncc_impl must be one of {NCC_IMPLS}, got "
                         f"{params.ncc_impl!r}")
    if params.ncc_impl != "auto":
        return params.ncc_impl
    return "svolume" if params.n_best == 1 else "direct"


class PlaneState(NamedTuple):
    """Per-pixel plane hypotheses."""
    normal: torch.Tensor     # (H, W, 3) unit normal, rebased ref frame
    d: torch.Tensor          # (H, W) plane offset
    cost: torch.Tensor       # (H, W) aggregated matching cost
    ratio: torch.Tensor      # (H, W) best / second-best view cost
    best_view: torch.Tensor  # (H, W) int32 best source view id

    @property
    def shape(self):
        return tuple(self.d.shape)


def depth_map(state: PlaneState, cams: geo.CameraSet) -> torch.Tensor:
    """Per-pixel depth induced by the plane field."""
    H, W = state.shape
    xx, yy = geo.pixel_grid(H, W, state.d.device)
    return geo.depth_from_plane(cams, state.normal, state.d, xx, yy)


def refine_schedule(params: AlgorithmParams) -> list[tuple[float, float]]:
    """(delta_disp, delta_normal) per refine scale: max_disparity *
    refine_dz0_frac shrinking /10 down to refine_delta_z_min, normal radius
    1.0 shrinking /4."""
    out = []
    dz = params.max_disparity * params.refine_dz0_frac
    dn = params.refine_delta_n_init
    while dz >= params.refine_delta_z_min:
        out.append((dz, dn))
        dz /= params.refine_delta_z_shrink
        dn /= params.refine_delta_n_shrink
    return out


def iteration_schedule(params: AlgorithmParams,
                       n_levels: int) -> tuple[int, ...]:
    """Iterations per pyramid level, coarse to fine: the coarsest runs
    `iterations`, lifted levels min(iterations, iterations_fine) (0 = all
    levels run `iterations`)."""
    fine = (min(params.iterations, params.iterations_fine)
            if params.iterations_fine else params.iterations)
    return (params.iterations,) + (fine,) * (n_levels - 1)


def prop_bank_count(params: AlgorithmParams) -> int:
    """Banks used by a propagation pass: the last `prop_banks` of
    cb.BANKS (the near banks sit at the end). 0 selects all 8, as the JAX
    package's `[-0:]` slice does; so does any count >= 8."""
    n = params.prop_banks
    return n if 0 < n < len(cb.BANKS) else len(cb.BANKS)


def prop_banks(params: AlgorithmParams):
    """The banks of a propagation pass: the last prop_bank_count of
    cb.BANKS."""
    return cb.BANKS[len(cb.BANKS) - prop_bank_count(params):]


def svolume_plane_counts(cams: geo.CameraSet, view_ids, height: int,
                         width: int,
                         params: AlgorithmParams) -> tuple[int, ...]:
    """Per-view plane counts for one reference view (host side)."""
    idx = list(view_ids)
    s_lo, s_hi = sv.s_range_for_depths(params.depth_min, params.depth_max,
                                       params.svolume_margin)
    return tuple(sv.plane_counts(
        cams.A.cpu().numpy()[idx], cams.b.cpu().numpy()[idx], height, width,
        s_lo, s_hi, step_px=params.svolume_step_px,
        budget_bytes=params.svolume_budget_mb << 20))


def svolume_plane_counts_shared(cams_list: Sequence[geo.CameraSet],
                                view_ids_list: Sequence[Sequence[int]],
                                height: int, width: int,
                                params: AlgorithmParams
                                ) -> tuple[int, ...]:
    """Scene-shared plane counts: the per-source-slot max over all
    reference views, with the memory budget re-applied on the maxima (plane
    spacing sets accuracy, so these follow the JAX package exactly)."""
    As = [c.A.cpu().numpy()[list(v)] for c, v in zip(cams_list,
                                                     view_ids_list)]
    bs = [c.b.cpu().numpy()[list(v)] for c, v in zip(cams_list,
                                                     view_ids_list)]
    return _shared_plane_counts(As, bs, height, width, params)


def _shared_plane_counts(As, bs, height: int, width: int,
                         params: AlgorithmParams) -> tuple[int, ...]:
    """The per-slot max of plane_counts over the references' (A, b), with
    the budget re-applied on the maxima by coarsening the step 1.5x up to
    64 px."""
    s_lo, s_hi = sv.s_range_for_depths(params.depth_min, params.depth_max,
                                       params.svolume_margin)

    def shared(step):
        with np.errstate(divide="ignore", invalid="ignore"):
            # A padding slot (A = 0, b = 0) has no epipolar span: 2 planes.
            return np.stack([sv.plane_counts(A, b, height, width, s_lo,
                                             s_hi, step_px=step)
                             for A, b in zip(As, bs)]).max(axis=0)

    step = params.svolume_step_px
    out = shared(step)
    budget = params.svolume_budget_mb << 20
    while out.sum() * height * width * 2 > budget and step < 64.0:
        step *= 1.5
        out = shared(step)
    return tuple(int(c) for c in out)


def random_init_with(generator: torch.Generator, shape: tuple[int, int],
                     cams: geo.CameraSet, rays: torch.Tensor, cost_fn,
                     params: AlgorithmParams) -> PlaneState:
    """Random planes: disparity uniform in [min_disparity, max_disparity],
    normal uniform on the camera-facing hemisphere; costs from the same
    cost function the iterations use."""
    H, W = shape
    dev = rays.device
    u = torch.rand((H, W), generator=generator, device=dev)
    disp = params.min_disparity + (params.max_disparity
                                   - params.min_disparity) * u
    depth = geo.disparity_depth(cams.f, cams.baseline, disp)
    n = geo.normalize(torch.randn((H, W, 3), generator=generator,
                                  device=dev))
    n = geo.hemisphere_flip(n, geo.view_vectors(cams, H, W))
    d = geo.plane_d_from_depth(n, rays, depth)
    mv = cost_fn(n, d, None)
    return PlaneState(normal=n, d=d, cost=mv.cost, ratio=mv.ratio,
                      best_view=mv.best_view)


def state_from_prior(depth: torch.Tensor, normal: torch.Tensor,
                     cams: geo.CameraSet) -> PlaneState:
    """Lift a prior depth/normal map (H, W), (H, W, 3) into planes: rotate
    world-frame normals into the rebased reference frame with R_orig[0]
    and set d through the pixel rays. Every pixel gets cost 1.0, ratio 0
    and best view -1; the cost is not re-evaluated."""
    H, W = depth.shape
    normal = geo.matvec3(cams.R_orig[0], normal)
    d = geo.plane_d_from_depth(normal, geo.pixel_rays(cams, H, W), depth)
    return PlaneState(
        normal=normal, d=d,
        cost=torch.full((H, W), 1.0, device=depth.device),
        ratio=torch.zeros((H, W), device=depth.device),
        best_view=torch.full((H, W), -1, dtype=torch.int32,
                             device=depth.device))


class ParityCtx(NamedTuple):
    """Packed-layout constants per parity: dense pixel coordinates, rays
    and view vectors of each parity class, each (H, W/2[, 3])."""
    coords: tuple
    rays: tuple
    vv: tuple


def make_parity_ctx(stats_by_parity, cams: geo.CameraSet, height: int,
                    width: int) -> ParityCtx:
    vv = geo.view_vectors(cams, height, width)
    return ParityCtx(
        coords=tuple(cb.parity_coords(height, width, p, cams.device)
                     for p in (0, 1)),
        rays=tuple(stats_by_parity[p].rays for p in (0, 1)),
        vv=tuple(cb.parity_compress_vec(vv, p) for p in (0, 1)))


def _own(state: PlaneState) -> PlaneState:
    """A contiguous copy of `state` that the half-passes may update in
    place."""
    return PlaneState(*(t.clone(memory_format=torch.contiguous_format)
                        for t in state))


def _propagation_pass(state: PlaneState, parity: int, cost_fn,
                      cams: geo.CameraSet, params: AlgorithmParams,
                      pctx: ParityCtx | None) -> PlaneState:
    """One checkerboard propagation half-pass on a copy of `state`: each
    pixel of `parity` evaluates its bank candidates (one batched
    multi-view evaluation over the bank axis, on the plane scalars the
    selection computed) and keeps the cheapest in-range one. With `pctx`
    None (odd sides) the candidates are evaluated on the dense grid and
    only the parity's pixels take them. Kernel B6 (ops/halfpass.py)
    selects and accepts on CUDA tensors, its plain version on CPU
    tensors."""
    state = _own(state)
    hp.propagation(state, parity, prop_banks(params),
                   hp.make_grid(cams, *state.shape, pctx), cost_fn)
    return state


def _refinement_pass(state: PlaneState, parity: int,
                     generator: torch.Generator, cost_fn,
                     cams: geo.CameraSet, params: AlgorithmParams,
                     pctx: ParityCtx | None) -> PlaneState:
    """One checkerboard refinement half-pass on a copy of `state`: a
    random search in (disparity, normal) over the shrinking scales of
    refine_schedule, with sequential accepts (each scale perturbs the
    previous scale's result); each scale draws hp.draw_refine from
    `generator` before its proposal. With `pctx` None (odd sides) the
    draws and evaluations cover the dense grid and only the parity's
    pixels accept. Kernel B6 proposes and accepts on CUDA tensors, its
    plain version on CPU tensors."""
    sched = refine_schedule(params)
    if not sched:
        return state
    state = _own(state)
    grid = hp.make_grid(cams, *state.shape, pctx)
    hp.refinement(state, parity, grid, cost_fn, sched,
                  hp.refine_draws(generator, grid, state, len(sched)),
                  params.min_disparity, params.max_disparity)
    return state


def make_patchmatch_step(cost_fn, cams: geo.CameraSet,
                         params: AlgorithmParams, pctx: ParityCtx | None,
                         rays: torch.Tensor):
    """One iteration: black propagation, black refinement, red
    propagation, red refinement, each in place (hp.propagation and
    hp.refinement on the level's grid). Returns step(state, generator),
    which updates `state` (contiguous; _own makes such a copy) and
    returns it. `rays` (H, W, 3) are the dense grid's."""
    grid = hp.make_grid(cams, *rays.shape[:2], pctx, rays)
    banks, sched = prop_banks(params), refine_schedule(params)

    def step(state: PlaneState, generator: torch.Generator) -> PlaneState:
        for parity in (0, 1):
            hp.propagation(state, parity, banks, grid, cost_fn)
            hp.refinement(state, parity, grid, cost_fn, sched,
                          hp.refine_draws(generator, grid, state, len(sched)),
                          params.min_disparity, params.max_disparity)
        return state
    return step


def _make_cost_and_ctx(stats, cams: geo.CameraSet, height: int, width: int,
                       eval_cost, compress):
    """cost_fn(normal, d, parity, scalars=None) -> MultiviewCost and the
    ParityCtx of the packed passes, from eval_cost(normal, d, stats,
    parity, scalars) and the stats' parity compressor; with odd sides a
    dense-only cost_fn and pctx None. `scalars` are the planes' (s0, sx,
    sy) when the caller has them (kernel B6 computes them with the
    candidates); else the cost function computes them."""
    if not cb.parity_compressible(height, width):
        def dense_cost_fn(normal, d, parity=None, scalars=None):
            return eval_cost(normal, d, stats, None, scalars)
        return dense_cost_fn, None
    stats_p = {None: stats, 0: compress(stats, 0), 1: compress(stats, 1)}
    pctx = make_parity_ctx(stats_p, cams, height, width)

    def cost_fn(normal, d, parity=None, scalars=None):
        return eval_cost(normal, d, stats_p[parity], parity, scalars)
    return cost_fn, pctx


def make_svolume_cost_fn(stats: ncc.RefStats, cams: geo.CameraSet,
                         height: int, width: int, vol: sv.SVolume,
                         ids: torch.Tensor, params: AlgorithmParams):
    """cost_fn(normal, d, parity) -> MultiviewCost on the s-volume, with
    parity None the dense grid and 0/1 the packed classes; and the
    ParityCtx of the packed passes (None for odd sides)."""
    def eval_cost(normal, d, st, parity, scalars):
        return sv.multiview_cost_svolume(vol, ids, normal, d, st, params,
                                         parity=parity, scalars=scalars)
    return _make_cost_and_ctx(stats, cams, height, width, eval_cost,
                              ncc.compress_stats)


def make_direct_cost_fn(stats, cams: geo.CameraSet, height: int,
                        width: int, imgs: torch.Tensor, ids: torch.Tensor,
                        params: AlgorithmParams):
    """cost_fn and ParityCtx, as make_svolume_cost_fn, on the direct
    sampler (kernel B3 on the card): imgs (V, H, W) grayscale with
    ncc.RefStats, or (V, 3, H, W) colour with ncc_color.ColorRefStats,
    index 0 the reference; ids the source positions."""
    views = cuda_direct.make_views(imgs[ids], cams.A[ids], cams.b[ids], ids)
    return direct_cost_fn_from_views(stats, cams, height, width, views,
                                     params)


def direct_cost_fn_from_views(stats, cams: geo.CameraSet, height: int,
                              width: int, views: cuda_direct.DirectViews,
                              params: AlgorithmParams):
    """make_direct_cost_fn on views packed by the caller (their warp
    factors need not come from `cams`)."""
    color = isinstance(stats, ncc_color.ColorRefStats)

    def eval_cost(normal, d, st, parity, scalars):
        s0, sx, sy = (ncc.plane_scalars(normal, d, st) if scalars is None
                      else scalars)
        return cuda_direct.multiview_cost_direct(views, s0, sx, sy, st,
                                                 params, parity)
    return _make_cost_and_ctx(
        stats, cams, height, width, eval_cost,
        ncc_color.compress_stats_color if color else ncc.compress_stats)


def run_patchmatch(generator: torch.Generator, imgs: torch.Tensor,
                   view_ids: tuple[int, ...], cams: geo.CameraSet,
                   params: AlgorithmParams,
                   iterations: int | None = None,
                   init_state: PlaneState | None = None,
                   svol_planes: tuple[int, ...] | None = None,
                   imgs_color: torch.Tensor | None = None) -> PlaneState:
    """Random (or lifted) init plus N checkerboard iterations. imgs (V, H,
    W) f32 with index 0 the reference. With `color_processing` and
    `imgs_color` (V, 3, H, W) the cost is the colour NCC on the direct
    sampler; otherwise the sampler resolve_ncc_impl picks. Only the
    s-volume path counts planes (`svol_planes` overrides) and builds
    volumes. A lifted `init_state` keeps its stored (coarse-level) costs:
    re-evaluating them through this level's volume displaces the lifted
    planes."""
    H, W = imgs.shape[1:]
    idx = torch.as_tensor(list(view_ids), dtype=torch.int64,
                          device=imgs.device)
    if params.color_processing and imgs_color is not None:
        stats = ncc_color.precompute_ref_stats_color(imgs_color[0], cams,
                                                     params)
        cost_fn, pctx = make_direct_cost_fn(stats, cams, H, W, imgs_color,
                                            idx, params)
    elif resolve_ncc_impl(params) == "direct":
        stats = ncc.precompute_ref_stats(imgs[0], cams, params)
        cost_fn, pctx = make_direct_cost_fn(stats, cams, H, W, imgs, idx,
                                            params)
    else:
        if svol_planes is None:
            svol_planes = svolume_plane_counts(cams, view_ids, H, W, params)
        stats = ncc.precompute_ref_stats(imgs[0], cams, params)
        s_lo, s_hi = sv.s_range_for_depths(params.depth_min,
                                           params.depth_max,
                                           params.svolume_margin)
        vol = sv.build_svolume(imgs[idx], cams.A[idx], cams.b[idx], s_lo,
                               s_hi, svol_planes)
        cost_fn, pctx = make_svolume_cost_fn(stats, cams, H, W, vol, idx,
                                             params)
    iters = params.iterations if iterations is None else iterations
    return _iterate(generator, cost_fn, pctx, stats.rays, cams, params,
                    iters, init_state)


def _iterate(generator: torch.Generator, cost_fn, pctx: ParityCtx | None,
             rays: torch.Tensor, cams: geo.CameraSet,
             params: AlgorithmParams, iterations: int,
             init_state: PlaneState | None) -> PlaneState:
    """Random init (unless `init_state` is given; its costs are kept, and
    it is copied, not updated) and `iterations` checkerboard iterations on
    cost_fn."""
    if init_state is None:
        state = random_init_with(generator, tuple(rays.shape[:2]), cams,
                                 rays, cost_fn, params)
    else:
        state = _own(init_state) if iterations else init_state
    step = make_patchmatch_step(cost_fn, cams, params, pctx, rays)
    for _ in range(iterations):
        state = step(state, generator)
    return state


# ---------------------------------------------------------------------------
# Batched multi-reference runner: the unit each rank of a view-sharded run
# loops over its slice of the reference views (parallel/mesh.py).
# ---------------------------------------------------------------------------

class SceneBatch(NamedTuple):
    """R reference views, each matched against up to S source views; slots
    past a reference's sources are padding (src_valid False). Warp factors
    are in each reference's own rebased frame with view 0's K."""
    ref_ids: torch.Tensor    # (R,) int32 image id of each reference
    src_ids: torch.Tensor    # (R, S) int32 image ids of its sources
    src_valid: torch.Tensor  # (R, S) bool: the slot holds a source
    A: torch.Tensor          # (R, S, 3, 3) K R_rel K^-1
    b: torch.Tensor          # (R, S, 3)    K t_rel


def build_scene_batch(P_list, ref_ids: Sequence[int],
                      src_ids_per_ref: Sequence[Sequence[int]],
                      num_src: int, cam_scale: float = 1.0, *,
                      device: torch.device | str) -> SceneBatch:
    """The (R, S) warp factors from raw projections and a view-selection
    table, in float64 on the host, cast to float32 on `device`. Every
    reference uses view 0's K as K_ref, as the JAX package does."""
    Ks, Rs, ts = [], [], []
    for P in P_list:
        K, R, C = geo.decompose_projection(np.asarray(P, np.float64))
        Ks.append(geo.scale_K(K, cam_scale))
        Rs.append(R)
        ts.append(-R @ C)
    K_ref = Ks[0]
    K_inv = np.linalg.inv(K_ref)
    R_, S = len(ref_ids), num_src
    A = np.zeros((R_, S, 3, 3))
    b = np.zeros((R_, S, 3))
    sid = np.zeros((R_, S), np.int32)
    valid = np.zeros((R_, S), bool)
    for i, ref in enumerate(ref_ids):
        for j, src in enumerate(list(src_ids_per_ref[i])[:S]):
            R_rel = Rs[src] @ Rs[ref].T
            t_rel = ts[src] - R_rel @ ts[ref]
            A[i, j] = K_ref @ R_rel @ K_inv
            b[i, j] = K_ref @ t_rel
            sid[i, j] = src
            valid[i, j] = True

    def arr(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)
    return SceneBatch(ref_ids=arr(ref_ids, np.int32), src_ids=arr(sid),
                      src_valid=arr(valid), A=arr(A, np.float32),
                      b=arr(b, np.float32))


def svolume_plane_counts_batch(batch: SceneBatch, height: int, width: int,
                               params: AlgorithmParams
                               ) -> tuple[int, ...] | None:
    """Per-slot plane counts shared by every reference of the batch: the
    maximum over all R references, with the memory budget re-applied by
    coarsening the step 1.5x up to 64 px. None off the s-volume path.
    Computed on the full batch, so every rank gets the same volumes."""
    if resolve_ncc_impl(params) != "svolume":
        return None
    return _shared_plane_counts(batch.A.cpu().numpy(), batch.b.cpu().numpy(),
                                height, width, params)


def batch_sampler(imgs: torch.Tensor, src_ids: torch.Tensor,
                  src_valid: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                  params: AlgorithmParams,
                  svol_planes: Sequence[int] | None = None):
    """(sampler, ids) of one reference of a SceneBatch: imgs (N, H, W)
    every image of the scene, src_ids/src_valid (S,), A (S, 3, 3), b (S,
    3) its slots. Only the valid slots enter the kernels' view tables (the
    JAX package masks the others to MAXCOST inside the aggregation, which
    gives the same top-2 and best-n); ids (n_valid,) are their image ids,
    which best_view reports. On the s-volume the sampler is an sv.SVolume
    (kernel B2 builds one volume per valid slot, with the per-slot
    `svol_planes`, default this reference's own counts); on the direct
    sampler the sources packed once for kernel B3
    (cuda_direct.DirectViews)."""
    keep = torch.nonzero(src_valid.cpu()).reshape(-1).tolist()
    if not keep:
        raise ValueError("a reference view needs at least one valid source "
                         "slot")
    idx = torch.as_tensor(keep, dtype=torch.int64, device=imgs.device)
    ids = src_ids.to(imgs.device)[idx].to(torch.int64)
    src_imgs = imgs[ids]
    A, b = A[idx], b[idx]
    if resolve_ncc_impl(params) == "direct":
        return cuda_direct.make_views(src_imgs, A, b, ids), ids
    H, W = imgs.shape[1:]
    s_lo, s_hi = sv.s_range_for_depths(params.depth_min, params.depth_max,
                                       params.svolume_margin)
    if svol_planes is None:
        counts = sv.plane_counts(A.cpu().numpy(), b.cpu().numpy(), H, W,
                                 s_lo, s_hi, step_px=params.svolume_step_px,
                                 budget_bytes=params.svolume_budget_mb << 20)
    else:
        counts = [svol_planes[k] for k in keep]
    return sv.build_svolume(src_imgs, A, b, s_lo, s_hi, counts), ids


def make_batch_cost_fn(stats: ncc.RefStats, cams: geo.CameraSet,
                       height: int, width: int, sampler, ids: torch.Tensor,
                       params: AlgorithmParams):
    """cost_fn and ParityCtx of one reference of a SceneBatch on the
    sampler `batch_sampler` built: B1 on an sv.SVolume, B3 on
    cuda_direct.DirectViews."""
    if isinstance(sampler, cuda_direct.DirectViews):
        return direct_cost_fn_from_views(stats, cams, height, width,
                                         sampler, params)
    return make_svolume_cost_fn(stats, cams, height, width, sampler, ids,
                                params)


def patchmatch_one_ref(generator: torch.Generator, imgs: torch.Tensor,
                       ref_id: int, src_ids: torch.Tensor,
                       src_valid: torch.Tensor, A: torch.Tensor,
                       b: torch.Tensor, cams: geo.CameraSet,
                       params: AlgorithmParams, iterations: int,
                       svol_planes: Sequence[int] | None = None,
                       init_state: PlaneState | None = None) -> PlaneState:
    """PatchMatch for one reference of a SceneBatch: imgs (N, H, W) every
    image, the slots' ids, mask and warp factors (batch_sampler); cams
    gives the shared intrinsics and depth range. A lifted `init_state`
    keeps its coarse costs, as in run_patchmatch_pyramid."""
    ref_img = imgs[int(ref_id)]
    H, W = ref_img.shape
    stats = ncc.precompute_ref_stats(ref_img, cams, params)
    sampler, ids = batch_sampler(imgs, src_ids, src_valid, A, b, params,
                                 svol_planes)
    cost_fn, pctx = make_batch_cost_fn(stats, cams, H, W, sampler, ids,
                                       params)
    return _iterate(generator, cost_fn, pctx, stats.rays, cams, params,
                    iterations, init_state)


def fold_in(seed: int, *data: int) -> int:
    """A generator seed from `seed` and `data` (the role of chained
    jax.random.fold_in): the same numbers give the same seed in every
    process."""
    entropy = [int(x) % (1 << 64) for x in (seed, *data)]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


def run_patchmatch_many(seed: int, imgs: torch.Tensor, batch: SceneBatch,
                        cams: geo.CameraSet, params: AlgorithmParams,
                        iterations: int,
                        svol_planes: Sequence[int] | None = None,
                        init_states: Sequence[PlaneState] | None = None,
                        level: int = 0) -> list[PlaneState]:
    """patchmatch_one_ref over the batch's references in order, one state
    each. Reference r draws from a generator seeded fold_in(seed, level,
    image id of r), so its result does not depend on which rank runs it
    or on the other references of the batch. init_states: one lifted state
    per reference (a coarser pyramid level)."""
    out = []
    for r in range(batch.ref_ids.shape[0]):
        ref = int(batch.ref_ids[r])
        gen = torch.Generator(device=imgs.device).manual_seed(
            fold_in(seed, level, ref))
        out.append(patchmatch_one_ref(
            gen, imgs, ref, batch.src_ids[r], batch.src_valid[r],
            batch.A[r], batch.b[r], cams, params, iterations,
            svol_planes=svol_planes,
            init_state=None if init_states is None else init_states[r]))
    return out


# ---------------------------------------------------------------------------
# Coarse-to-fine pyramid
# ---------------------------------------------------------------------------

def downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """2x area-average downsample of the trailing (H, W) dims."""
    H2 = (img.shape[-2] // 2) * 2
    W2 = (img.shape[-1] // 2) * 2
    img = img[..., :H2, :W2]
    return 0.25 * (img[..., 0::2, 0::2] + img[..., 0::2, 1::2]
                   + img[..., 1::2, 0::2] + img[..., 1::2, 1::2])


def depth_map_with_f(state: PlaneState, cams_fine: geo.CameraSet,
                     coarse_shape: tuple[int, int]) -> torch.Tensor:
    """Depth of a coarse state with the coarse intrinsics (fx, cx, cy
    halve with the image)."""
    Hc, Wc = coarse_shape
    xx, yy = geo.pixel_grid(Hc, Wc, state.d.device)
    f_c = cams_fine.f * 0.5
    cx_c = cams_fine.cx * 0.5
    cy_c = cams_fine.cy * 0.5
    denom = (state.normal[..., 0] * (xx - cx_c)
             + state.normal[..., 1] * (yy - cy_c) * cams_fine.alpha
             + state.normal[..., 2] * f_c)
    return -state.d * f_c / denom


def upsample_state_2x(state: PlaneState, cams_fine: geo.CameraSet,
                      height: int, width: int) -> PlaneState:
    """Lift a coarse plane field to the next finer scale: nearest-repeat
    the normals and the induced depth (edge-padded to odd sizes), rebuild
    d with the finer intrinsics, and carry cost, ratio and best view."""
    Hc, Wc = state.shape
    dev = state.d.device
    iy = torch.clamp(torch.arange(height, device=dev) // 2, max=Hc - 1)
    ix = torch.clamp(torch.arange(width, device=dev) // 2, max=Wc - 1)

    def up(a):
        return a.index_select(0, iy).index_select(1, ix)

    normal = up(state.normal)
    depth = up(depth_map_with_f(state, cams_fine, (Hc, Wc)))
    rays = geo.pixel_rays(cams_fine, height, width)
    return PlaneState(normal=normal,
                      d=geo.plane_d_from_depth(normal, rays, depth),
                      cost=up(state.cost), ratio=up(state.ratio),
                      best_view=up(state.best_view))


def level_params(params: AlgorithmParams, li: int, f: float,
                 depth_min: float, depth_max: float) -> AlgorithmParams:
    """The parameters of pyramid level `li` (0 the coarsest) with focal
    length `f`: lifted levels narrow the first refine scale
    (refine_dz0_frac_fine) and use prop_banks_fine banks; every level
    derives its disparity range from its own focal length."""
    if li > 0:
        params = dataclasses.replace(
            params,
            refine_dz0_frac=min(params.refine_dz0_frac,
                                params.refine_dz0_frac_fine),
            prop_banks=min(params.prop_banks, params.prop_banks_fine))
    return params.with_depth_range(depth_min, depth_max, f)


def run_patchmatch_pyramid(generator: torch.Generator, imgs: torch.Tensor,
                           view_ids: tuple[int, ...], P_list,
                           params: AlgorithmParams,
                           levels: tuple[int, ...] = (4, 2, 1),
                           iterations_per_level: tuple[int, ...] | None
                           = None,
                           depth_min: float | None = None,
                           depth_max: float | None = None,
                           svol_planes_per_level: Sequence[
                               tuple[int, ...] | None] | None = None,
                           imgs_color: torch.Tensor | None = None
                           ) -> PlaneState:
    """Coarse-to-fine PatchMatch over `levels` (downsample factors, coarse
    to fine, the last 1). imgs (V, H, W) f32 on the device; P_list the raw
    projections in pipeline order; imgs_color (V, 3, H, W) the colour
    images of `color_processing`, pyramided like imgs. Lifted levels
    narrow the first refine scale (refine_dz0_frac_fine), use
    prop_banks_fine banks and keep their coarse costs, on every
    sampler."""
    if levels[-1] != 1:
        raise ValueError("the finest pyramid level must be 1")
    if iterations_per_level is None:
        iterations_per_level = iteration_schedule(params, len(levels))
    dmin = params.depth_min if depth_min is None else depth_min
    dmax = params.depth_max if depth_max is None else depth_max
    color = params.color_processing and imgs_color is not None
    pyr = {1: imgs}
    pyr_c = {1: imgs_color if color else None}
    fac, cur, cur_c = 1, imgs, pyr_c[1]
    while fac < max(levels):
        cur = downsample_2x(cur)
        if color:
            cur_c = downsample_2x(cur_c)
        fac *= 2
        pyr[fac] = cur
        pyr_c[fac] = cur_c

    state = None
    for li, s in enumerate(levels):
        cams_s = geo.build_camera_set(P_list,
                                      cam_scale=float(s) * params.cam_scale,
                                      depth_min=dmin, depth_max=dmax,
                                      device=imgs.device)
        params_s = level_params(params, li, float(cams_s.f), dmin, dmax)
        imgs_s = pyr[s]
        if state is not None:
            state = upsample_state_2x(state, cams_s, *imgs_s.shape[1:])
        planes = (svol_planes_per_level[li]
                  if svol_planes_per_level is not None else None)
        state = run_patchmatch(generator, imgs_s, view_ids, cams_s,
                               params_s, iterations=iterations_per_level[li],
                               init_state=state, svol_planes=planes,
                               imgs_color=pyr_c[s])
    return state
