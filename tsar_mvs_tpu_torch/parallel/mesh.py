"""View-axis sharding over a torch.distributed group (port of
``tsar_mvs_tpu.parallel.mesh``).

The reference's outer parallelism is a shell loop over reference views,
embarrassingly parallel. Each rank runs its contiguous slice of the
reference views (`distributed.process_local_slice`) on its own device;
the images are small and every rank holds all of them, so matching needs
no communication. The one cross-view step, fusion's consistency votes,
all-gathers the depth and normal maps and lets each rank vote for its
own references.

Collectives move tensors by the group's backend: CUDA tensors under
NCCL (one rank per GPU), a host round trip under gloo (CPU ranks, or
ranks sharing one card: NCCL refuses two ranks on one GPU, and gloo's
all_gather takes CPU tensors only). Compute stays on the rank's device
either way. Padding exists only so that a collective's tensors have equal
sizes: padded views have zero depths, which vote nothing, and view 0's
camera.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.config import AlgorithmParams, FusionParams
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.models.fusion import fusion_votes
from tsar_mvs_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class ViewMesh:
    """One rank's place on the view axis: its rank and the world size, the
    device it computes on, and the process group (None for a world of one
    without a group)."""
    rank: int
    world: int
    device: torch.device
    group: object | None = None

    def local_slice(self, n_total: int) -> slice:
        """This rank's contiguous slice of n_total views."""
        return distributed.process_local_slice(n_total, self.rank,
                                               self.world)

    def per_rank(self, n_total: int) -> int:
        """Views per rank once n_total is padded to a multiple of world."""
        return -(-n_total // self.world)


def view_mesh(device: torch.device | str = "cuda") -> ViewMesh:
    """The mesh of the initialised default process group, or a world of
    one without one. `device` defaults to the card and raises without
    one (pipeline.resolve_device); a bare "cuda" in a group means GPU
    rank % device_count, which NCCL ranks also make their current
    device."""
    from tsar_mvs_tpu_torch.pipeline import resolve_device
    device = resolve_device(device)
    if not dist.is_initialized():
        return ViewMesh(0, 1, device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  rank % torch.cuda.device_count())
        if dist.get_backend() == "nccl":
            torch.cuda.set_device(device)
    return ViewMesh(rank, world, device, dist.group.WORLD)


def all_gather(mesh: ViewMesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (equal shapes on every rank), in rank order, on
    t's device: CUDA tensors under NCCL, a host round trip under gloo;
    bool travels as uint8."""
    if mesh.group is None:
        return [t]
    backend = dist.get_backend(mesh.group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"all_gather: backend {backend!r} is neither nccl "
                         f"nor gloo")
    send = t.to(torch.uint8) if t.dtype == torch.bool else t
    if backend == "gloo":
        send = send.cpu()
    elif not send.is_cuda:
        raise ValueError("all_gather: NCCL gathers CUDA tensors; this rank "
                         "computes on the CPU")
    send = send.contiguous()
    out = [torch.empty_like(send) for _ in range(mesh.world)]
    dist.all_gather(out, send, group=mesh.group)
    return [o.to(device=t.device, dtype=t.dtype) for o in out]


def gather_views(mesh: ViewMesh, local: torch.Tensor,
                 n_total: int) -> torch.Tensor:
    """(n_local, ...) maps of this rank's slice of n_total views -> every
    view's (world * per_rank, ...), in view order, on every rank; a short
    slice sends zeros, so the padded views come last."""
    per = mesh.per_rank(n_total)
    pad = local.new_zeros((per - local.shape[0],) + tuple(local.shape[1:]))
    return torch.cat(all_gather(mesh, torch.cat([local, pad])))


def pad_batch(batch: pm.SceneBatch, multiple: int) -> pm.SceneBatch:
    """The JAX package's padding of the reference axis to a multiple of
    the mesh size: padded references replay view 0 with no valid source.
    The port's runners never need it (each rank runs its own slice) and
    refuse a reference without a valid source, so a padded reference is
    never computed."""
    R = batch.ref_ids.shape[0]
    pad = (-R) % multiple
    if pad == 0:
        return batch
    return pm.SceneBatch(*(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                           for a in batch))


def batch_rows(batch: pm.SceneBatch, rows: slice) -> pm.SceneBatch:
    """The references `rows` of a batch."""
    return pm.SceneBatch(*(a[rows] for a in batch))


def patchmatch_sharded(mesh: ViewMesh, seed: int, imgs: torch.Tensor,
                       batch: pm.SceneBatch, cams: geo.CameraSet,
                       params: AlgorithmParams, iterations: int,
                       svol_planes: Sequence[int] | None = None,
                       init_states: Sequence[pm.PlaneState] | None = None,
                       level: int = 0) -> list[pm.PlaneState]:
    """PatchMatch for this rank's slice of the batch's references (the
    full batch on every rank). Returns one state per local reference.
    svol_planes defaults to svolume_plane_counts_batch of the full batch,
    the same on every rank; init_states holds the local references'
    lifted states."""
    H, W = imgs.shape[1:]
    if svol_planes is None:
        svol_planes = pm.svolume_plane_counts_batch(batch, H, W, params)
    local = batch_rows(batch, mesh.local_slice(batch.ref_ids.shape[0]))
    return pm.run_patchmatch_many(seed, imgs, local, cams, params,
                                  iterations, svol_planes=svol_planes,
                                  init_states=init_states, level=level)


def scale_batch(batch: pm.SceneBatch, s: float) -> pm.SceneBatch:
    """Warp factors at pyramid scale s (K_s = diag(1/s, 1/s, 1) K):
    A_s = D A D^-1, b_s = D b."""
    D = torch.tensor([1.0 / s, 1.0 / s, 1.0], dtype=torch.float32,
                     device=batch.A.device)
    return batch._replace(A=batch.A * D[:, None] * (1.0 / D)[None, :],
                          b=batch.b * D)


class LevelInputs(NamedTuple):
    """What patchmatch_sharded gets on one pyramid level."""
    index: int                 # 0 the coarsest
    imgs: torch.Tensor         # (N, H_s, W_s) every image at this level
    cams: geo.CameraSet        # rebuilt from P_list at this scale
    params: AlgorithmParams    # level_params of this level
    batch: pm.SceneBatch       # the full batch's warp factors scaled
    svol_planes: tuple[int, ...] | None  # shared over the full batch


def pyramid_level_inputs(imgs: torch.Tensor, batch: pm.SceneBatch,
                         params: AlgorithmParams, levels: tuple[int, ...],
                         P_list, depth_min: float, depth_max: float):
    """LevelInputs of each level, coarse to fine: the images downsampled,
    the cameras rebuilt from the raw projections `P_list`, the sequential
    pyramid's level_params, the warp factors scaled (scale_batch) and the
    plane counts of the full batch, the same on every rank."""
    pyr = {1: imgs}
    fac, cur = 1, imgs
    while fac < max(levels):
        cur = pm.downsample_2x(cur)
        fac *= 2
        pyr[fac] = cur
    for li, s in enumerate(levels):
        imgs_s = pyr[s]
        cams_s = geo.build_camera_set(list(P_list),
                                      cam_scale=float(s) * params.cam_scale,
                                      depth_min=depth_min,
                                      depth_max=depth_max,
                                      device=imgs.device)
        params_s = pm.level_params(params, li, float(cams_s.f), depth_min,
                                   depth_max)
        batch_s = scale_batch(batch, float(s)) if s != 1 else batch
        yield LevelInputs(li, imgs_s, cams_s, params_s, batch_s,
                          pm.svolume_plane_counts_batch(
                              batch_s, *imgs_s.shape[1:], params_s))


def patchmatch_sharded_pyramid(mesh: ViewMesh, seed: int,
                               imgs: torch.Tensor, batch: pm.SceneBatch,
                               cams: geo.CameraSet, params: AlgorithmParams,
                               iterations: int,
                               levels: tuple[int, ...] = (4, 2, 1),
                               P_list=None, depth_min: float | None = None,
                               depth_max: float | None = None
                               ) -> list[pm.PlaneState]:
    """Coarse-to-fine PatchMatch of this rank's references: levels in the
    outer loop (pyramid_level_inputs), the local references in the inner
    one, as the JAX package does; the lifted states re-enter as
    init_states (keeping their coarse costs). iteration_schedule is the
    sequential pyramid's."""
    if levels[-1] != 1:
        raise ValueError("the finest pyramid level must be 1")
    if P_list is None:
        raise ValueError("P_list is required for the per-level cameras")
    dmin = float(cams.depth_min) if depth_min is None else depth_min
    dmax = float(cams.depth_max) if depth_max is None else depth_max
    iters = pm.iteration_schedule(
        dataclasses.replace(params, iterations=iterations), len(levels))
    states = None
    for lv in pyramid_level_inputs(imgs, batch, params, levels, P_list,
                                   dmin, dmax):
        Hs, Ws = lv.imgs.shape[1:]
        if states is not None:
            states = [pm.upsample_state_2x(st, lv.cams, Hs, Ws)
                      for st in states]
        states = patchmatch_sharded(mesh, seed, lv.imgs, lv.batch, lv.cams,
                                    lv.params, iters[lv.index],
                                    svol_planes=lv.svol_planes,
                                    init_states=states, level=lv.index)
    return states


def fuse_sharded(mesh: ViewMesh, depths: torch.Tensor,
                 normals: torch.Tensor, cams_world: geo.CameraSet,
                 fp: FusionParams):
    """Fusion consistency votes with the references sharded over the
    ranks: all_gather the depth and normal maps, vote for this rank's
    references with the one `fusion_votes` and an empty `used` mask, and
    gather the votes back in global order, one reference slot at a time.

    depths (n_local, H, W), normals (n_local, H, W, 3): the maps of this
    rank's slice of the cams_world.P.shape[0] views; cams_world
    (not rebased) covers world * per_rank views, the padding with view 0's
    camera (padded views have zero depths).

    used_list de-dup is sequential over the references; this path votes
    with an empty used mask and returns each reference's consumed-source
    maps, so `apply_used_list` replays the emission de-dup on the host.
    Vote counts stay pre-dedup (the sequential path also denies consumed
    pixels their votes), so the output is a superset of `models.fusion.
    fuse`'s: +85% emitted points at num_consistent=2 on the JAX package's
    48x64x8 proxy (tests/test_parallel.py::
    test_fuse_sharded_num_consistent2_delta). Exact output: fuse_scene.

    Returns host numpy (point_sum (Vp, H, W, 3), normal_sum (Vp, H, W, 3),
    count (Vp, H, W), emit (Vp, H, W), consumed (Vp, Vp, H, W)) on every
    rank, Vp = world * per_rank; rows of padded views are zero."""
    Vp = cams_world.P.shape[0]
    if Vp % mesh.world:
        raise ValueError("fuse_sharded: pad the cameras to a multiple of "
                         "the world size")
    per = Vp // mesh.world
    H, W = depths.shape[1:]
    d_all = gather_views(mesh, depths, Vp)
    n_all = gather_views(mesh, normals, Vp)
    used = torch.zeros((Vp, H, W), dtype=torch.bool, device=depths.device)
    out = (np.zeros((Vp, H, W, 3), np.float32),
           np.zeros((Vp, H, W, 3), np.float32),
           np.zeros((Vp, H, W), np.int32), np.zeros((Vp, H, W), bool),
           np.zeros((Vp, Vp, H, W), bool))
    # What a short slice sends for its padded slots.
    zeros = tuple(torch.as_tensor(np.zeros_like(o[0]), device=depths.device)
                  for o in out)
    for i in range(per):
        votes = (fusion_votes(mesh.rank * per + i, d_all, n_all, cams_world,
                              used, fp)
                 if i < depths.shape[0] else zeros)
        for field, t in enumerate(votes):
            for k, part in enumerate(all_gather(mesh, t)):
                out[field][k * per + i] = part.cpu().numpy()
    return out


def apply_used_list(emit: np.ndarray, consumed: np.ndarray) -> np.ndarray:
    """Sequential used_list replay over per-ref vote results (host side).

    emit: (V, H, W) pre-dedup emit masks; consumed: (V_ref, V_src, H, W)
    source pixels each ref's emitted points consumed. Returns deduped
    emit masks: a pixel already consumed by an earlier reference view no
    longer emits (models.fusion.fuse's `used` semantics at vote time,
    applied post-hoc)."""
    V = emit.shape[0]
    used = np.zeros_like(emit)
    out = np.zeros_like(emit)
    for r in range(V):
        keep = emit[r] & ~used[r]
        out[r] = keep
        # Only points still emitted consume their sources.
        used |= consumed[r] & keep[None]
    return out
