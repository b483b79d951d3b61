"""Whole-scene run with the reference views sharded over the ranks (port
of ``tsar_mvs_tpu.parallel.scene_sharded``).

The reference's outer parallelism is its shell loop over reference views.
Here each rank runs the whole per-view pipeline for its contiguous slice
of the references, phase by phase over its local references as the JAX
package does:

  A. pyramid PatchMatch          parallel.mesh.patchmatch_sharded_pyramid
  B. confidence + LR check       ncc.rl_cost_fused_traced per reference
  C. coarse WMF outlier marks
  D. host: weak texture, region RANSAC and the border check
  E. fill, fine WMF and finalize with each reference's world rotation
  F. fusion votes                parallel.mesh.fuse_sharded (all_gather)

Only phase F and the gathering of the results communicate. Divergences
from sequential `pipeline.process_view` x `pipeline.fuse_scene` are those
of the JAX package, listed on `process_scene_sharded`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.config import AlgorithmParams, FusionParams
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.models import tsar
from tsar_mvs_tpu_torch.models import weak_texture as wt
from tsar_mvs_tpu_torch.models.fusion import FusedCloud
from tsar_mvs_tpu_torch.ops import ncc
from tsar_mvs_tpu_torch.parallel import mesh as pmesh
from tsar_mvs_tpu_torch.utils import dmb, ply


def confidence_sharded(states: Sequence[pm.PlaneState],
                       batch: pm.SceneBatch, imgs: torch.Tensor,
                       cams: geo.CameraSet, params: AlgorithmParams):
    """Phase B for the local references (batch holds their rows):
    confidence, LR difference and disparity per reference, with the
    reverse cost from the batch's warp factors."""
    confids, lrdiffs, disps = [], [], []
    for i, st in enumerate(states):
        src_ids = batch.src_ids[i].to(torch.int64)
        rl = ncc.rl_cost_fused_traced(
            imgs[int(batch.ref_ids[i])], imgs[src_ids], st.best_view,
            src_ids, batch.src_valid[i], batch.A[i], batch.b[i], cams,
            st.normal, st.d, params)
        lrdiff = torch.clamp(torch.abs(st.cost - rl),
                             max=params.lr_diff_clamp)
        confids.append(((2.0 - st.cost) / 2.0 + (1.0 - lrdiff)) / 2.0)
        lrdiffs.append(lrdiff)
        disps.append(tsar.disparity_of(cams, st.normal, st.d))
    return confids, lrdiffs, disps


def wmf_mark_sharded(states: Sequence[pm.PlaneState],
                     ref_imgs: Sequence[torch.Tensor],
                     disps: Sequence[torch.Tensor],
                     reliables: Sequence[torch.Tensor],
                     cams: geo.CameraSet, params: AlgorithmParams,
                     iters: int = 4) -> list[torch.Tensor]:
    """Phase C: the coarse WMF outlier marking of each local reference."""
    return [tsar.wmf_stage(g, cams, st, dp, rel, params, iters=iters)
            for st, g, dp, rel in zip(states, ref_imgs, disps, reliables)]


def fill_finalize_sharded(states: Sequence[pm.PlaneState],
                          ref_imgs: torch.Tensor,
                          disps: Sequence[torch.Tensor],
                          reliables: Sequence[torch.Tensor],
                          planes: Sequence[np.ndarray],
                          weaks: Sequence[wt.WeakTexture],
                          R_orig_inv: torch.Tensor, cams: geo.CameraSet,
                          params: AlgorithmParams,
                          wmf_final_iters: int = 6):
    """Phase E for the local references (ref_imgs (n_local, H, W)):
    textureless fill from the region planes, fine WMF hole filling, and
    finalize with each reference's own world rotation R_orig_inv
    (n_local, 3, 3). Returns lists of states, disparities and reliability
    masks, and the stacked (n_local, H, W) depths and (n_local, H, W, 3)
    world normals."""
    dev = ref_imgs.device
    out_states, out_disps, out_rels = [], [], []
    depths = ref_imgs.new_zeros(ref_imgs.shape)
    normals = ref_imgs.new_zeros(tuple(ref_imgs.shape) + (3,))
    for i, st in enumerate(states):
        labels = torch.as_tensor(weaks[i].labels_full, dtype=torch.int64,
                                 device=dev)
        st, rel, disp = tsar.fill_stage(
            cams, st, torch.as_tensor(planes[i], device=dev), labels,
            torch.as_tensor(weaks[i].text == -1, device=dev), reliables[i],
            params)
        textured = torch.as_tensor(weaks[i].text == 1, device=dev)[labels]
        st, disp, rel = tsar.wmf_final_stage(ref_imgs[i], cams, st, disp,
                                             rel, textured, params,
                                             iters=wmf_final_iters)
        depths[i] = tsar.finalize_stage(cams, st)[0]
        normals[i] = geo.matvec3(R_orig_inv[i], st.normal)
        out_states.append(st)
        out_disps.append(disp)
        out_rels.append(rel)
    return out_states, out_disps, out_rels, depths, normals


def scene_batch(scene, params: AlgorithmParams,
                device: torch.device) -> pm.SceneBatch:
    """Every view as a reference with the sources of its view selection
    (pipeline.view_image_order): the full batch, which every rank builds
    on the host and holds."""
    from tsar_mvs_tpu_torch import pipeline as pl
    orders = [pl.view_image_order(scene, r, params.max_views,
                                  min_angle=params.min_angle,
                                  max_angle=params.max_angle)[0]
              for r in range(len(scene.names))]
    return pm.build_scene_batch(list(scene.P), list(range(len(orders))),
                                [o[1:] for o in orders],
                                max(len(o) - 1 for o in orders),
                                device=device)


def process_scene_sharded(scene, params: AlgorithmParams | None = None,
                          fp: FusionParams | None = None, seed: int = 0,
                          pm_iterations: int | None = None,
                          mesh: pmesh.ViewMesh | None = None,
                          write_artifacts: bool = True, fuse: bool = True,
                          timer=None, pm_depths: dict | None = None):
    """Whole-scene run (PatchMatch, TSAR refinement, fusion) with the
    reference views split over the ranks of `mesh` (default
    `view_mesh()`: the initialised group, or a world of one on the card).
    Every rank loads the scene; each runs its own references and, with
    `write_artifacts`, writes their TSAR_disp.dmb and TSAR_normals.dmb
    (no per-view PLY); rank 0 writes results/TSAR_fused.ply.

    Divergences from sequential `pipeline.process_view` x
    `pipeline.fuse_scene`, the JAX package's own:
      * every reference uses view 0's intrinsics as K_ref
        (`build_scene_batch`);
      * the random streams are keyed by the global reference id
        (`run_patchmatch_many`; RANSAC by 999 + id), so the result does
        not depend on the number of ranks;
      * fusion is the parallel vote with the host used-list replay
        (`fuse_sharded` + `apply_used_list`), a superset of the
        sequential fusion at num_consistent > 1.
    The sampler is resolve_ncc_impl's; colour NCC is not on this path
    (the JAX package's has no colour branch either), so
    `color_processing` raises.

    `timer(name)` is called after each phase with its name ("A" .. "F",
    then "gather"); `pm_depths`, when a dict, receives the PatchMatch
    depth map (numpy) of each local reference by image id.

    Returns (depths (V, H, W), normals_world (V, H, W, 3), cloud or None)
    as numpy, on every rank."""
    from tsar_mvs_tpu_torch import pipeline as pl
    params = pl.default_params_for_scene(scene, params)
    if params.color_processing:
        raise ValueError("the sharded scene path is grayscale, as the JAX "
                         "package's: run color_processing sequentially")
    fp = fp or FusionParams()
    mesh = mesh or pmesh.view_mesh()
    mark = timer or (lambda name: None)
    dev = mesh.device
    V = len(scene.names)
    H, W = scene.images.shape[1:]

    batch = scene_batch(scene, params, dev)
    cams = geo.build_camera_set(list(scene.P), cam_scale=params.cam_scale,
                                depth_min=scene.depth_min,
                                depth_max=scene.depth_max, device=dev)
    imgs = torch.as_tensor(scene.images, dtype=torch.float32, device=dev)
    iters = params.iterations if pm_iterations is None else pm_iterations
    refs = list(range(V))[mesh.local_slice(V)]
    local = pmesh.batch_rows(batch, mesh.local_slice(V))

    # A: pyramid PatchMatch of the local references.
    states = pmesh.patchmatch_sharded_pyramid(
        mesh, seed, imgs, batch, cams, params, iters,
        levels=pl.pyramid_levels_for(H), P_list=list(scene.P),
        depth_min=scene.depth_min, depth_max=scene.depth_max)
    if pm_depths is not None:
        for r, st in zip(refs, states):
            pm_depths[r] = pm.depth_map(st, cams).cpu().numpy()
    mark("A")

    # B: confidence.
    _, _, disps = confidence_sharded(states, local, imgs, cams, params)
    mark("B")

    # C: coarse WMF marks.
    ref_imgs = imgs[refs]
    reliables = [torch.ones((H, W), dtype=torch.bool, device=dev)
                 for _ in refs]
    if params.wmf_iters > 0:
        reliables = wmf_mark_sharded(states, ref_imgs, disps, reliables,
                                     cams, params, iters=params.wmf_iters)
    mark("C")

    # D: weak texture (B7 on a card), region RANSAC and the border check.
    weaks, planes = [], []
    for i, r in enumerate(refs):
        weak = wt.detect_weak_texture(scene.images[r], params, device=dev)
        gen = torch.Generator(device=dev).manual_seed(
            pm.fold_in(seed, 999 + r))
        pr = tsar.fit_region_planes(gen, weak, disps[i],
                                    reliables[i].cpu().numpy(), cams, params)
        if params.border_check:
            pr = tsar.border_veto(cams, pr, weak, disps[i], params)
        weaks.append(weak)
        planes.append(pr)
    mark("D")

    # E: fill, fine WMF, finalize.
    # cams.R_orig_inv holds every view's own world rotation (rebasing
    # changes R, not R_orig).
    _, _, _, depths, normals_world = fill_finalize_sharded(
        states, ref_imgs, disps, reliables, planes, weaks,
        cams.R_orig_inv[refs], cams, params,
        wmf_final_iters=params.wmf_final_iters)
    del states, disps, reliables
    mark("E")

    if write_artifacts:
        for i, r in enumerate(refs):
            out_dir = Path(scene.root) / "results" / scene.names[r]
            out_dir.mkdir(parents=True, exist_ok=True)
            dmb.write_dmb(out_dir / "TSAR_disp.dmb", depths[i].cpu().numpy())
            dmb.write_dmb(out_dir / "TSAR_normals.dmb",
                          normals_world[i].cpu().numpy())

    cloud = None
    if fuse:
        # Padded views take view 0's camera and zero depths.
        Vp = mesh.world * mesh.per_rank(V)
        cams_world = geo.build_camera_set(
            list(scene.P) + [scene.P[0]] * (Vp - V),
            cam_scale=params.cam_scale, rebase=False, device=dev)
        ps, nsum, count, emit, consumed = pmesh.fuse_sharded(
            mesh, depths, normals_world, cams_world, fp)
        emit = emit[:V]
        if fp.used_list:
            emit = pmesh.apply_used_list(emit, consumed[:V, :V])
        del consumed
        pts, nrms, cols, view_of = [], [], [], []
        for r in range(V):
            denom = (count[r] + 1).astype(np.float32)[..., None]
            n_avg = nsum[r] / denom
            n_avg /= np.maximum(
                np.linalg.norm(n_avg, axis=-1, keepdims=True), 1e-12)
            sel = emit[r]
            pts.append((ps[r] / denom)[sel])
            nrms.append(n_avg[sel])
            cols.append(scene.images[r][sel].astype(np.uint8))
            view_of.append(np.full(int(sel.sum()), r, np.int32))
        cloud = FusedCloud(points=np.concatenate(pts),
                           normals=np.concatenate(nrms),
                           colors=np.concatenate(cols),
                           view_of=np.concatenate(view_of))
        if write_artifacts and mesh.rank == 0:
            out = Path(scene.root) / "results" / "TSAR_fused.ply"
            out.parent.mkdir(parents=True, exist_ok=True)
            ply.write_ply(out, cloud.points, cloud.normals, cloud.colors)
        mark("F")

    # Every rank's maps, after every rank wrote its artifacts.
    depths_np = pmesh.gather_views(mesh, depths, V)[:V].cpu().numpy()
    normals_np = pmesh.gather_views(mesh, normals_world,
                                    V)[:V].cpu().numpy()
    mark("gather")
    return depths_np, normals_np, cloud
