"""Scene and view pipeline with the reference's on-disk contract (port of
``tsar_mvs_tpu.pipeline``).

    <scene>/images/<name>.png|.pfm       input views
    <scene>/cams/<name>_cam.txt          cameras + depth range
    <scene>/pair.txt                     ranked source views per reference
    <scene>/APD/<name>/depths_geom.dmb   optional prior depth (APD contract)
    <scene>/APD/<name>/normals.dmb       optional prior normals
    <scene>/APD/<name>/weak.png          optional reliability seed
    <scene>/results/<name>/TSAR_disp.dmb      metric depth
    <scene>/results/<name>/TSAR_normals.dmb   world-frame normals
    <scene>/results/<name>/TSAR_model.ply     per-view point cloud
    <scene>/results/<name>/TSAR_slic*.{png,dmb,txt}  superpixel artifacts
    <scene>/results/<name>/TSAR_results.txt   runtime log
    <scene>/results/TSAR_fused.ply            fused scene cloud

Per view: weak-texture detection and SLIC on the host, then either the
lifted APD prior (PatchMatch only when asked for, grayscale) or the
coarse-to-fine PatchMatch pyramid on the device (on the colour images
under -color_processing), TSAR refinement, artifacts. A scene is the views
one after another, then fusion; or, in a process group, each rank's slice
of the views (``parallel.scene_sharded``).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tsar_mvs_tpu_torch.config import AlgorithmParams, FusionParams
from tsar_mvs_tpu_torch.models import weak_texture as wt
from tsar_mvs_tpu_torch.utils import display, dmb, ply, scene_io
from tsar_mvs_tpu_torch.utils.pfm import read_pfm
from tsar_mvs_tpu_torch.utils.synthetic import read_png_gray
from tsar_mvs_tpu_torch import geometry as geo
from tsar_mvs_tpu_torch.models import fusion as fusion_mod
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.models import tsar
from tsar_mvs_tpu_torch.ops import slic as slic_mod

# View image formats load_scene reads (and the CLI routes to gipuma).
IMAGE_SUFFIXES = (".png", ".pfm", ".jpg", ".jpeg", ".JPG")


@dataclass
class Scene:
    root: Path
    names: list[str]               # view names in id order
    images: np.ndarray             # (V, H, W) float32 grayscale
    P: np.ndarray                  # (V, 3, 4) world-frame projections
    depth_min: float
    depth_max: float
    pair: scene_io.PairFile
    # (V, 3, H, W) float32 RGB, loaded on first use by -color_processing
    # (the reference loads img_color only then too, main.cpp:1303-1306).
    images_color: np.ndarray | None = None
    images_dir: Path | None = None
    # Scene-shared plane counts per (level scale, n_src), filled by
    # scene_plane_counts.
    _svol_counts_cache: dict | None = None

    def load_color(self) -> np.ndarray:
        if self.images_color is None:
            self.images_color = np.stack(
                [_read_rgb(self._image_path(n)) for n in self.names])
        return self.images_color

    def _image_path(self, name: str) -> Path:
        """The file load_scene read view `name` from (the first suffix in
        sorted order)."""
        img_dir = self.images_dir or self.root / "images"
        found = sorted(p for p in img_dir.iterdir()
                       if p.stem == name and p.suffix in IMAGE_SUFFIXES)
        if not found:
            raise FileNotFoundError(name)
        return found[0]


def load_scene(root: str | Path, images_folder: str | Path | None = None,
               p_folder: str | Path | None = None,
               calib_file: str | Path | None = None,
               depth_min: float | None = None,
               depth_max: float | None = None) -> Scene:
    """Load a scene with the reference's camera-source precedence: KITTI
    `calib_file` (two views) > Strecha `p_folder` (`<name>.P` or
    `<name>.png.P`) > `cams/<name>_cam.txt` (which also gives the depth
    range, from view 0, unless `depth_min`/`depth_max` are given).
    `images_folder` overrides where the view images load from; without a
    depth range from either source it is (-1, -1)."""
    root = Path(root)
    img_dir = Path(images_folder) if images_folder else root / "images"
    paths = {}
    for p in sorted(img_dir.iterdir()):
        if p.suffix in IMAGE_SUFFIXES and p.stem not in paths:
            paths[p.stem] = p
    names = sorted(paths)
    images = [_read_gray(paths[n]) for n in names]
    if calib_file is not None:
        if len(names) != 2:
            raise ValueError("-calib_file is a two-view (KITTI) contract; "
                             f"got {len(names)} images")
        P_list = list(scene_io.read_kitti_calib(calib_file))
    elif p_folder is not None:
        P_list = []
        for name in names:
            p_path = Path(p_folder) / f"{name}.P"
            if not p_path.exists():
                p_path = Path(p_folder) / f"{name}.png.P"
            P_list.append(scene_io.read_p_file(p_path))
    else:
        P_list = []
        for name in names:
            cam = scene_io.read_cam_file(root / "cams" / f"{name}_cam.txt")
            P_list.append(cam.P)
            if depth_min is None:
                depth_min, depth_max = cam.depth_min, cam.depth_max
    if depth_min is None:
        depth_min, depth_max = -1.0, -1.0
    pair_path = root / "pair.txt"
    pair = (scene_io.read_pair_file(pair_path) if pair_path.exists()
            else scene_io.PairFile())
    return Scene(root=root, names=names, images=np.stack(images),
                 P=np.stack(P_list), depth_min=float(depth_min),
                 depth_max=float(depth_max), pair=pair, images_dir=img_dir)


def _read_gray(path: Path) -> np.ndarray:
    """Grayscale float32 image from .pfm/.png/.jpg."""
    if path.suffix == ".pfm":
        img = read_pfm(path)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        return np.asarray(img, np.float32)
    if path.suffix == ".png":
        return np.asarray(read_png_gray(path), np.float32)
    from PIL import Image
    return np.asarray(Image.open(path).convert("L"), np.float32)


def _read_rgb(path: Path) -> np.ndarray:
    """(3, H, W) float32 RGB (IMREAD_COLOR analogue, main.cpp:1305); a
    grayscale source gives three equal channels."""
    if path.suffix == ".pfm":
        img = np.asarray(read_pfm(path), np.float32)
        if img.ndim == 2:
            return np.repeat(img[None], 3, axis=0)
        return np.ascontiguousarray(img.transpose(2, 0, 1)[:3])
    from PIL import Image
    arr = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def view_image_order(scene: Scene, ref_idx: int, max_views: int,
                     min_angle: float = 5.0, max_angle: float = 45.0
                     ) -> tuple[list[int], tuple[int, ...]]:
    """[ref] + source views from pair.txt, or from the angle-based
    selection without one. Returns (image ids in pipeline order, source
    positions 1..S)."""
    if scene.pair.neighbors:
        src = scene.pair.source_ids(ref_idx, max_views)
    else:
        from tsar_mvs_tpu_torch.models.view_selection import \
            select_views_angle
        src = select_views_angle(list(scene.P), ref_idx, scene.depth_min,
                                 scene.depth_max, min_angle=min_angle,
                                 max_angle=max_angle, max_views=max_views)
        if not src:
            src = [i for i in range(len(scene.names))
                   if i != ref_idx][:max_views]
    order = [ref_idx] + list(src)
    return order, tuple(range(1, len(order)))


def default_params_for_scene(scene: Scene,
                             params: AlgorithmParams | None = None
                             ) -> AlgorithmParams:
    params = params or AlgorithmParams()
    K, _, _ = geo.decompose_projection(scene.P[0])
    return params.with_depth_range(scene.depth_min, scene.depth_max,
                                   K[0, 0] / params.cam_scale)


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device. The entry points default to the card;
    asking for it on a machine without one raises, so nothing runs on
    the CPU unless the caller says device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run on "
                           "the CPU")
    return device


def pyramid_levels_for(height: int) -> tuple[int, ...]:
    """Coarse-to-fine downsample factors of the PatchMatch pyramid."""
    return (4, 2, 1) if height >= 1024 else (2, 1)


def scene_plane_counts(scene: Scene, params: AlgorithmParams,
                       levels: tuple[int, ...], n_src: int
                       ) -> list[tuple[int, ...] | None]:
    """Scene-shared s-volume plane counts per pyramid level (max over all
    reference views with n_src sources, budget re-applied), cached on the
    Scene; None per level off the s-volume path."""
    if params.color_processing or pm.resolve_ncc_impl(params) != "svolume":
        return [None] * len(levels)
    H, W = scene.images.shape[1:]
    if scene._svol_counts_cache is None:
        scene._svol_counts_cache = {}
    dims = {1: (H, W)}
    h, w, fac = H, W, 1
    while fac < max(levels):
        h, w, fac = h // 2, w // 2, fac * 2
        dims[fac] = (h, w)
    out = []
    for s in levels:
        key = (s, n_src)
        if key not in scene._svol_counts_cache:
            cams_list, vids_list = [], []
            for ref_idx in range(len(scene.names)):
                order, view_ids = view_image_order(
                    scene, ref_idx, params.max_views,
                    min_angle=params.min_angle, max_angle=params.max_angle)
                if len(view_ids) != n_src:
                    continue
                cams_list.append(geo.build_camera_set(
                    [scene.P[i] for i in order],
                    cam_scale=float(s) * params.cam_scale,
                    depth_min=scene.depth_min, depth_max=scene.depth_max,
                    device="cpu"))  # plane counts are host arithmetic
                vids_list.append(view_ids)
            scene._svol_counts_cache[key] = pm.svolume_plane_counts_shared(
                cams_list, vids_list, *dims[s], params)
        out.append(scene._svol_counts_cache[key])
    return out


def run_slic_stage(gray: np.ndarray, params: AlgorithmParams,
                   device: torch.device | str = "cuda"
                   ) -> tuple[np.ndarray, slic_mod.SlicResult]:
    """SLIC on the quarter-scale reference image. Returns (full-resolution
    nearest-upsampled labels, quarter-scale SlicResult)."""
    g = torch.as_tensor(np.asarray(gray, np.float32),
                        device=resolve_device(device))
    q = pm.downsample_2x(pm.downsample_2x(g))
    res = slic_mod.slic(slic_mod.gray_to_feature(q),
                        spixel_size=params.slic_spixel_size,
                        coh_weight=params.slic_coh_weight,
                        n_iters=params.slic_iters)
    lab = res.labels.cpu().numpy()
    H, W = gray.shape
    lab_full = np.repeat(np.repeat(lab, 4, axis=0), 4, axis=1)[:H, :W]
    if lab_full.shape != (H, W):
        lab_full = np.pad(lab_full, ((0, H - lab_full.shape[0]),
                                     (0, W - lab_full.shape[1])),
                          mode="edge")
    return lab_full, res


def write_slic_graph(path: Path, adjacency: dict, sizes: dict,
                     borders: dict) -> None:
    """One line per superpixel: `id size n_neighbors nb:borderlen ...`,
    after a first line with the superpixel count."""
    with Path(path).open("w") as fh:
        fh.write(f"{len(sizes)}\n")
        for label in sorted(sizes):
            nbs = sorted(adjacency.get(label, ()))
            parts = [f"{label}", f"{sizes[label]}", f"{len(nbs)}"]
            for nb in nbs:
                parts.append(f"{nb}:{borders.get((min(label, nb), max(label, nb)), 0)}")
            fh.write(" ".join(parts) + "\n")


def read_slic_graph(path: Path) -> tuple[dict, dict, dict]:
    """Inverse of write_slic_graph."""
    adjacency: dict[int, set[int]] = {}
    sizes: dict[int, int] = {}
    borders: dict[tuple[int, int], int] = {}
    for ln in Path(path).read_text().splitlines()[1:]:
        toks = ln.split()
        label, size, n_nb = int(toks[0]), int(toks[1]), int(toks[2])
        sizes[label] = size
        adjacency[label] = set()
        for t in toks[3:3 + n_nb]:
            nb, bl = (int(v) for v in t.split(":"))
            adjacency[label].add(nb)
            borders[(min(label, nb), max(label, nb))] = bl
    return adjacency, sizes, borders


def process_view(scene: Scene, ref_idx: int,
                 params: AlgorithmParams | None = None,
                 generator: torch.Generator | None = None,
                 out_dir: str | Path | None = None,
                 pm_iterations: int | None = None,
                 write_ply: bool = True,
                 write_vis: bool = False,
                 device: torch.device | str = "cuda",
                 timer=None) -> tsar.TsarResult:
    """Full per-view run: weak texture -> SLIC -> [APD prior | PatchMatch
    pyramid] -> TSAR refinement -> artifacts in `out_dir` (default
    results/<name>).

    With `APD/<name>/depths_geom.dmb` present the prior is lifted into
    planes and `weak.png > 0` seeds the reliability mask; PatchMatch then
    runs only for `pm_iterations` > 0 (default 0), at full resolution from
    the lifted state. Otherwise `pm_iterations` overrides the pyramid's
    iterations. `write_vis` adds the normal, disparity and confidence PNGs
    and the parameter dump. `device` defaults to the card and raises
    without one (device="cpu" runs the plain versions of the kernels).
    `generator` (a torch.Generator on `device`) defaults to one seeded 0.
    `timer(name)`, when given, is called at each stage boundary with the
    name of the stage that just ended (the stage names of bench.py)."""
    t0 = time.time()
    device = resolve_device(device)
    mark = timer or (lambda name: None)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = default_params_for_scene(scene, params)
    order, view_ids = view_image_order(scene, ref_idx, params.max_views,
                                       min_angle=params.min_angle,
                                       max_angle=params.max_angle)
    cams = geo.build_camera_set([scene.P[i] for i in order],
                                cam_scale=params.cam_scale,
                                depth_min=scene.depth_min,
                                depth_max=scene.depth_max, device=device)
    name = scene.names[ref_idx]
    gray = scene.images[ref_idx]
    mark("setup")
    weak = wt.detect_weak_texture(gray, params)
    mark("weak_texture")
    slic_labels, slic_res = run_slic_stage(gray, params, device)
    slic_adj, slic_sizes, slic_borders = \
        slic_mod.superpixel_graph_host(slic_res.labels.cpu().numpy())
    mark("slic")

    imgs = torch.as_tensor(scene.images[order], dtype=torch.float32,
                           device=device)
    prior_dir = scene.root / "APD" / name
    reliable_seed = None
    if (prior_dir / "depths_geom.dmb").exists():
        def load(fname):
            return torch.tensor(dmb.read_dmb(prior_dir / fname),
                                dtype=torch.float32, device=device)
        state = pm.state_from_prior(load("depths_geom.dmb"),
                                    load("normals.dmb"), cams)
        if (prior_dir / "weak.png").exists():
            reliable_seed = read_png_gray(prior_dir / "weak.png") > 0
        if (pm_iterations or 0) > 0:
            state = pm.run_patchmatch(generator, imgs, view_ids, cams, params,
                                      iterations=pm_iterations,
                                      init_state=state)
    else:
        iters = params.iterations if pm_iterations is None else pm_iterations
        levels = pyramid_levels_for(imgs.shape[1])
        imgs_color = None
        if params.color_processing:
            imgs_color = torch.as_tensor(scene.load_color()[order],
                                         dtype=torch.float32, device=device)
        state = pm.run_patchmatch_pyramid(
            generator, imgs, view_ids, [scene.P[i] for i in order], params,
            levels=levels,
            iterations_per_level=pm.iteration_schedule(
                dataclasses.replace(params, iterations=iters), len(levels)),
            depth_min=scene.depth_min, depth_max=scene.depth_max,
            svol_planes_per_level=scene_plane_counts(scene, params, levels,
                                                     len(view_ids)),
            imgs_color=imgs_color)
    mark("patchmatch")
    result = tsar.tsar_refine(imgs, cams, view_ids, params, state, weak,
                              generator, timer=mark,
                              reliable_seed=reliable_seed)

    out_dir = Path(out_dir) if out_dir is not None \
        else scene.root / "results" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    dmb.write_dmb(out_dir / "TSAR_disp.dmb", result.depth)
    dmb.write_dmb(out_dir / "TSAR_normals.dmb", result.normal_world)
    display.write_png(out_dir / "TSAR_slic.png",
                      display.slic_boundaries_for_display(
                          slic_res.labels.cpu().numpy(),
                          pm.downsample_2x(pm.downsample_2x(
                              torch.as_tensor(gray))).numpy()))
    dmb.write_dmb(out_dir / "TSAR_slic_labels.dmb",
                  slic_labels.astype(np.float32))
    write_slic_graph(out_dir / "TSAR_slic_graph.txt", slic_adj, slic_sizes,
                     slic_borders)
    if write_ply:
        cams_world = geo.build_camera_set([scene.P[i] for i in order],
                                          cam_scale=params.cam_scale,
                                          rebase=False, device="cpu")
        rgb = (scene.load_color()[ref_idx] if params.color_processing
               else None)
        write_view_ply(out_dir / "TSAR_model.ply", result, gray, cams_world,
                       rgb=rgb)
    if write_vis:
        display.write_png(out_dir / "TSAR_normals.png",
                          display.add_sphere_legend(
                              display.normals_for_display(
                                  result.normal_world)))
        display.write_png(out_dir / "TSAR_disp.png",
                          display.disparity_for_display(result.depth))
        display.write_png(out_dir / "TSAR_confidence.png",
                          display.confidence_for_display(result.confidence))
        display.write_parameters_file(out_dir / "TSAR_params.txt", params)
    runtime = time.time() - t0
    with (out_dir / "TSAR_results.txt").open("a") as fh:
        fh.write(f"Total runtime: {runtime:.3f} sec "
                 f"( {runtime / 60.0:.3f} min)\n")
        fh.write(f"SLIC: {len(slic_sizes)} superpixels, "
                 f"{sum(len(v) for v in slic_adj.values()) // 2} "
                 f"adjacencies, {len(slic_borders)} shared borders\n")
    mark("artifacts")
    return result


def write_view_ply(path: Path, result: tsar.TsarResult, gray: np.ndarray,
                   cams_world: geo.CameraSet,
                   rgb: np.ndarray | None = None) -> None:
    """Per-view point cloud in the world frame: every pixel emits a
    vertex; invalid depths become the origin. Vertex colours are the gray
    image, or `rgb` (3, H, W) under -color_processing."""
    H, W = result.depth.shape
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    X = geo.backproject(cams_world, 0, torch.as_tensor(xx),
                        torch.as_tensor(yy),
                        torch.as_tensor(result.depth)).numpy()
    bad = ~np.isfinite(X).all(axis=-1) | (result.depth <= 0)
    X = np.where(bad[..., None], 0.0, X)
    if rgb is not None:
        colors = np.clip(rgb, 0, 255).astype(np.uint8).transpose(
            1, 2, 0).reshape(-1, 3)
    else:
        colors = np.clip(gray, 0, 255).astype(np.uint8).reshape(-1)
    ply.write_ply(path, X.reshape(-1, 3),
                  result.normal_world.reshape(-1, 3), colors)


def process_scene(scene_root: str | Path,
                  params: AlgorithmParams | None = None, seed: int = 0,
                  write_ply: bool = True,
                  resume: bool = False,
                  device: torch.device | str = "cuda",
                  sharded: str | bool = "auto"
                  ) -> list[tsar.TsarResult | None]:
    """Every reference view of a scene on `device` (the card unless the
    caller says otherwise).

    Sequentially the views run one after another: with `resume`, views
    whose TSAR_disp.dmb exists are skipped (None in the result), and view
    i draws from a generator seeded seed * 1000003 + i. `sharded` "auto"
    takes the view-sharded path (parallel.scene_sharded) when an
    initialised process group has more than one rank and `resume` is off,
    as the JAX package does with more than one device; True forces it, at
    any world size, and False the sequential loop. The sharded path
    writes TSAR_disp and TSAR_normals (no per-view PLY), returns None
    entries and does not resume; `device` names the rank's device (a bare
    "cuda" is GPU rank % device_count). In a group of more than one rank
    the sequential loop runs on rank 0 alone (the others return None
    entries), and every rank returns once it has ended, so no two ranks
    write one view's files."""
    if sharded not in ("auto", True, False):
        raise ValueError(f"sharded must be 'auto', True or False, got "
                         f"{sharded!r}")
    device = resolve_device(device)
    scene = load_scene(scene_root)
    use_sharded = sharded is True or (
        sharded == "auto" and not resume and dist.is_initialized()
        and dist.get_world_size() > 1)
    if use_sharded:
        if resume:
            raise ValueError("the sharded scene path does not resume")
        from tsar_mvs_tpu_torch.parallel import mesh as pmesh
        from tsar_mvs_tpu_torch.parallel import scene_sharded
        scene_sharded.process_scene_sharded(
            scene, params, seed=seed, mesh=pmesh.view_mesh(device),
            fuse=False)
        return [None] * len(scene.names)
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    if grouped and dist.get_rank() != 0:
        dist.barrier()
        return [None] * len(scene.names)
    results = []
    for ref_idx, name in enumerate(scene.names):
        if resume and (scene.root / "results" / name
                       / "TSAR_disp.dmb").exists():
            results.append(None)
            continue
        gen = torch.Generator(device=device).manual_seed(
            seed * 1000003 + ref_idx)
        results.append(process_view(scene, ref_idx, params, gen,
                                    write_ply=write_ply, device=device))
    if grouped:
        dist.barrier()
    return results


def fuse_scene(scene_root: str | Path, fp: FusionParams | None = None,
               params: AlgorithmParams | None = None, *,
               device: torch.device | str) -> Path:
    """Fuse every view's TSAR_disp/TSAR_normals into
    results/TSAR_fused.ply (cameras not rebased: world frame) on
    `device`, which the caller names."""
    device = resolve_device(device)
    scene = load_scene(scene_root)
    fp = fp or FusionParams()
    params = default_params_for_scene(scene, params)
    res = scene.root / "results"
    depths = np.stack([dmb.read_dmb(res / n / "TSAR_disp.dmb")
                       for n in scene.names])
    normals = np.stack([dmb.read_dmb(res / n / "TSAR_normals.dmb")
                        for n in scene.names])
    cams_world = geo.build_camera_set(list(scene.P),
                                      cam_scale=params.cam_scale,
                                      rebase=False, device=device)
    cloud = fusion_mod.fuse(depths, normals, cams_world, scene.images, fp)
    out = res / "TSAR_fused.ply"
    ply.write_ply(out, cloud.points, cloud.normals, cloud.colors)
    return out
