"""Command line of the port, with the JAX CLI's commands and flag names:

    python -m tsar_mvs_tpu_torch.cli gipuma <images...> -mslp_folder <dir> ...
    python -m tsar_mvs_tpu_torch.cli view <scene_dir> <ref> [--vis]
    python -m tsar_mvs_tpu_torch.cli scene <scene_dir> [--fuse] [--resume]
    python -m tsar_mvs_tpu_torch.cli fuse <scene_dir> [--depth_diff=0.01 ...]
    python -m tsar_mvs_tpu_torch.cli eval <est> <gt> [--fscore]
    python -m tsar_mvs_tpu_torch.cli synth <out_dir> [--height --width --views]
    python -m tsar_mvs_tpu_torch.cli bench [--device cpu]

A first argument that is a flag or an image file runs `gipuma`, as the
reference binary's own command line does. `--device` defaults to `cuda`;
without a CUDA device the commands that compute exit with status 1
unless `--device cpu` is given. `-color_processing` (colour NCC) and
`--n_best` above 1 run PatchMatch on the direct sampler (kernel B3 on the
card). `scene --sharded on` runs each rank's slice of the reference views
(``parallel/``; ranks join through the TSAR_* environment, see
``parallel/distributed.py``); without that environment, on a host with
more than one card, `scene` spawns one rank per card. `bench` is the
one-view benchmark (``tsar_mvs_tpu_torch/bench.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams, FusionParams


def _alg_params(ns) -> AlgorithmParams:
    kw = {}
    if getattr(ns, "blocksize", None):
        kw["box_hsize"] = kw["box_vsize"] = ns.blocksize
    for flag, field in (("iterations", "iterations"),
                        ("cost_gamma", "gamma"), ("n_best", "n_best"),
                        ("cam_scale", "cam_scale"),
                        ("min_angle", "min_angle"),
                        ("max_angle", "max_angle"),
                        ("max_disparity", "max_disparity"),
                        ("max_views", "max_views"),
                        ("border_check_thr", "border_check_thr"),
                        ("iterations_fine", "iterations_fine"),
                        ("prop_banks_fine", "prop_banks_fine")):
        v = getattr(ns, flag, None)
        if v is not None:
            kw[field] = v
    if getattr(ns, "color_processing", False):
        kw["color_processing"] = True
    if getattr(ns, "border_check", False):
        kw["border_check"] = True
    if getattr(ns, "no_border_check", False):
        kw["border_check"] = False
    return AlgorithmParams(**kw)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; give --device cpu to "
                        "run on the CPU)")


def _device(ns) -> str | None:
    """The device to run on: --device, else cuda. None (after a message
    naming the flag) when cuda is asked for and there is none."""
    dev = ns.device or "cuda"
    if dev.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU",
              file=sys.stderr)
        return None
    return dev


def cmd_gipuma(argv: list[str]) -> int:
    """Per-view run with the reference binary's flag surface: the first
    positional image is the reference view, the rest are sources. Flags
    of Gipuma variants TSAR never runs are parsed and ignored; unknown
    flags warn, and `--flag=` tokens (unset shell variables in the
    reference scripts) are dropped so a script line runs verbatim."""
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.cli gipuma",
                                add_help=False)
    p.add_argument("images", nargs="*")
    p.add_argument("-mslp_folder", dest="mslp_folder", default=".")
    p.add_argument("-images_folder", dest="images_folder", default=None)
    p.add_argument("-p_folder", dest="p_folder", default=None)
    p.add_argument("-krt_file", dest="krt_file", default=None)
    p.add_argument("-calib_file", dest="calib_file", default=None)
    p.add_argument("-camera_folder", dest="camera_folder", default=None)
    p.add_argument("-bounding_folder", dest="bounding_folder", default=None)
    p.add_argument("-output_folder", dest="output_folder", default=None)
    p.add_argument("-o", dest="disparity_filename", default=None)
    p.add_argument("--pmvs_folder", dest="pmvs_folder", default=None)
    p.add_argument("--camera_idx", type=int, default=0)
    p.add_argument("--initial_seed", dest="seed_file", default=None)
    p.add_argument("-no_display", action="store_true")
    p.add_argument("-gt", dest="gt", default=None)
    p.add_argument("-gt_nocc", dest="gt_nocc", default=None)
    p.add_argument("-occl_mask", dest="occl_mask", default=None)
    p.add_argument("-gt_normal", dest="gt_normal", default=None)
    p.add_argument("--gtDepth_divisionFactor", type=float, default=1.0)
    p.add_argument("--gtDepth_tolerance", type=float, default=1.0)
    p.add_argument("--gtDepth_tolerance2", type=float, default=0.1)
    p.add_argument("--algorithm", default="pm")
    p.add_argument("--max-disparity", dest="max_disparity", type=float,
                   default=None)
    p.add_argument("--cam_scale", type=float, default=1.0)
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--blocksize", type=int, default=11)
    p.add_argument("--cost_gamma", type=float, default=10.0)
    p.add_argument("--cost_comb", default="best_n")
    p.add_argument("--n_best", type=int, default=1)
    p.add_argument("--min_angle", type=float, default=5.0)
    p.add_argument("--max_angle", type=float, default=45.0)
    p.add_argument("--max_views", type=int, default=14)
    p.add_argument("--depth_min", type=float, default=None)
    p.add_argument("--depth_max", type=float, default=None)
    p.add_argument("--num_img_processed", type=int, default=1)
    p.add_argument("-view_selection", action="store_true")
    for flag in ("--cost_tau_color", "--cost_tau_gradient", "--cost_alpha",
                 "--good_factor", "--disp_tol", "--norm_tol", "--ct_eps",
                 "--no_texture_sim", "--no_texture_per"):
        p.add_argument(flag, type=float, default=None)
    p.add_argument("--ss_n", type=int, default=None)
    p.add_argument("--border_value", type=int, default=None)
    p.add_argument("-color_processing", action="store_true")
    p.add_argument("--border_check", action="store_true")
    p.add_argument("--no_border_check", action="store_true")
    p.add_argument("--border_check_thr", type=float, default=None)
    p.add_argument("--iterations_fine", type=int, default=None)
    p.add_argument("--prop_banks_fine", type=int, default=None)
    _add_device(p)
    argv = [a for a in argv if not (a.startswith("-") and a.endswith("="))]
    ns, unknown = p.parse_known_args(argv)
    for u in unknown:
        print(f"Command-line parameter warning: unknown option {u}")
    if ns.algorithm != "pm":
        print(f"warning: --algorithm={ns.algorithm} selects a Gipuma "
              "variant TSAR does not run; proceeding with pm (NCC)")
    if ns.seed_file:
        print("warning: --initial_seed is parsed but unused, as in the "
              "reference")
    device = _device(ns)
    if device is None:
        return 1

    from tsar_mvs_tpu_torch import pipeline
    if ns.pmvs_folder:
        # PMVS layout: images under visualize/, Strecha P matrices under
        # txt/; --camera_idx picks the reference image.
        print(f"Using pmvs information inside directory {ns.pmvs_folder}")
        ns.images_folder = str(Path(ns.pmvs_folder) / "visualize")
        ns.p_folder = str(Path(ns.pmvs_folder) / "txt")
        ns.images = []
    scene = pipeline.load_scene(Path(ns.mslp_folder),
                                images_folder=ns.images_folder,
                                p_folder=ns.p_folder,
                                calib_file=ns.calib_file,
                                depth_min=ns.depth_min,
                                depth_max=ns.depth_max)
    if ns.pmvs_folder:
        ref_name = scene.names[ns.camera_idx]
        print(f"Using image {ref_name} as reference camera")
    else:
        ref_name = Path(ns.images[0]).stem if ns.images else scene.names[0]
    ref_idx = scene.names.index(ref_name)
    if ns.bounding_folder:
        scene = _apply_bounding_volume(scene, ref_idx, ns.bounding_folder)
    out_dir = (Path(ns.output_folder) / ref_name if ns.output_folder
               else None)
    result = pipeline.process_view(scene, ref_idx, _alg_params(ns),
                                   out_dir=out_dir,
                                   write_vis=not ns.no_display,
                                   device=device)
    if ns.gt:
        from tsar_mvs_tpu_torch import eval as ev
        from tsar_mvs_tpu_torch.utils.dmb import read_dmb
        from tsar_mvs_tpu_torch.utils.synthetic import read_png_gray
        gt = read_dmb(ns.gt) / ns.gtDepth_divisionFactor
        occl = read_png_gray(ns.occl_mask) if ns.occl_mask else None
        r = ev.depth_error(result.depth, gt,
                           tolerance=ns.gtDepth_tolerance, occl_mask=occl)
        out = {"error": r.error, "error_nocc": r.error_nocc,
               "error_valid": r.error_valid}
        if ns.gt_normal:
            nr = ev.normal_error(result.normal_world, read_dmb(ns.gt_normal))
            out["normal_mean_deg"] = nr.mean_deg
        print(json.dumps(out))
    return 0


def _apply_bounding_volume(scene, ref_idx: int, bounding_folder: str):
    """Clamp the scene's depth range to the depth extent of the bounding
    box's 8 corners in the reference camera."""
    from tsar_mvs_tpu_torch.utils import scene_io
    bv = Path(bounding_folder)
    candidates = sorted(bv.glob("*.txt")) or [bv]
    bl, tr = scene_io.read_bounding_volume(candidates[0])
    corners = np.array([[x, y, z] for x in (bl[0], tr[0])
                        for y in (bl[1], tr[1]) for z in (bl[2], tr[2])])
    P = scene.P[ref_idx]
    depths = (P[2, :3] @ corners.T) + P[2, 3]
    dmin = float(max(depths.min(), 1e-6))
    dmax = float(depths.max())
    lo = max(scene.depth_min, dmin) if scene.depth_min > 0 else dmin
    hi = min(scene.depth_max, dmax) if scene.depth_max > 0 else dmax
    return dataclasses.replace(scene, depth_min=lo, depth_max=hi)


def cmd_scene(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.cli scene")
    p.add_argument("scene_dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--blocksize", type=int, default=None)
    p.add_argument("--cam_scale", type=float, default=None)
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-ply", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip views whose TSAR_disp.dmb already exists")
    p.add_argument("--fuse", action="store_true",
                   help="run fusion after all views")
    p.add_argument("--border_check", action="store_true",
                   help="veto implausible region fills (the default)")
    p.add_argument("--no_border_check", action="store_true",
                   help="reference-exact behaviour (veto off)")
    p.add_argument("--border_check_thr", type=float, default=None)
    p.add_argument("--iterations_fine", type=int, default=None,
                   help="PatchMatch iterations on lifted pyramid levels")
    p.add_argument("--prop_banks_fine", type=int, default=None,
                   help="propagation banks on lifted pyramid levels")
    p.add_argument("-color_processing", dest="color_processing",
                   action="store_true",
                   help="3-channel bilateral NCC on the colour images "
                        "(direct sampler)")
    p.add_argument("--sharded", choices=("auto", "on", "off"),
                   default="auto",
                   help="view sharding over the ranks of a process group "
                        "(joined from the TSAR_COORDINATOR, "
                        "TSAR_NUM_PROCESSES, TSAR_PROCESS_ID environment; "
                        "TSAR_BACKEND nccl or gloo; without it, on a host "
                        "with more than one card, one spawned NCCL rank "
                        "per card): 'on' shards at any world size, 'auto' "
                        "when the group has more than one rank (not with "
                        "--resume), 'off' runs the views one after another")
    _add_device(p)
    ns = p.parse_args(argv)
    if ns.sharded == "on" and ns.color_processing:
        print("-color_processing is not on the sharded path (nor in the "
              "JAX package): use --sharded off", file=sys.stderr)
        return 2
    device = _device(ns)
    if device is None:
        return 1
    import torch.distributed as dist
    from tsar_mvs_tpu_torch.parallel import distributed
    sharded = {"auto": "auto", "on": True, "off": False}[ns.sharded]
    args = (ns.scene_dir, _alg_params(ns), ns.seed, not ns.no_ply,
            ns.resume, sharded, ns.fuse)
    if (ns.sharded != "off" and not ns.resume and not dist.is_initialized()
            and not os.environ.get("TSAR_COORDINATOR")
            and device == "cuda" and torch.cuda.device_count() > 1):
        # As the JAX package shards over every device the process sees:
        # one NCCL rank per card (a card named by index runs alone). The
        # kernels are built here once, not in every rank.
        from tsar_mvs_tpu_torch import _build
        _build.load_library()
        with tempfile.TemporaryDirectory() as tmp:
            distributed.run_ranks(_scene_rank, torch.cuda.device_count(),
                                  f"file://{tmp}/pg", "nccl",
                                  ("cuda", *args))
        return 0
    joined = False
    if ns.sharded != "off" and not dist.is_initialized():
        joined = distributed.initialize(
            "gloo" if torch.device(device).type == "cpu" else None)
    try:
        _scene_rank(device, *args)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


def _scene_rank(device: str, scene_dir: str, params: AlgorithmParams,
                seed: int, write_ply: bool, resume: bool,
                sharded: str | bool, fuse: bool) -> None:
    """`scene` in this process (a module-level function, so that spawned
    ranks can run it): process_scene on `device` (in a group a bare "cuda"
    is the rank's card), then, with `fuse`, fuse_scene on rank 0. Every
    rank's artifacts are on disk once process_scene returns (on either
    path its last step is a collective)."""
    import torch.distributed as dist
    from tsar_mvs_tpu_torch import pipeline
    pipeline.process_scene(scene_dir, params, seed=seed,
                           write_ply=write_ply, resume=resume, device=device,
                           sharded=sharded)
    if fuse and (not dist.is_initialized() or dist.get_rank() == 0):
        out = pipeline.fuse_scene(scene_dir, device=device)
        print(f"fused cloud: {out}")


def cmd_view(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.cli view")
    p.add_argument("scene_dir")
    p.add_argument("ref", help="view index or name")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--blocksize", type=int, default=None)
    p.add_argument("--vis", action="store_true",
                   help="write normal/disparity/confidence PNGs and the "
                        "parameter dump")
    _add_device(p)
    ns = p.parse_args(argv)
    device = _device(ns)
    if device is None:
        return 1
    from tsar_mvs_tpu_torch import pipeline
    scene = pipeline.load_scene(ns.scene_dir)
    ref_idx = (int(ns.ref) if ns.ref.isdigit()
               else scene.names.index(ns.ref))
    pipeline.process_view(scene, ref_idx, _alg_params(ns),
                          write_vis=ns.vis, device=device)
    return 0


def cmd_fuse(argv: list[str]) -> int:
    """Fusion with the reference Fusion.exe flag names."""
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.cli fuse")
    p.add_argument("scene_dir")
    p.add_argument("--num_consistent", type=int, default=1)
    p.add_argument("--reproj_error", type=float, default=2.0)
    p.add_argument("--depth_diff", type=float, default=0.01)
    p.add_argument("--angle", type=float, default=15.0)
    p.add_argument("--used_list", type=int, default=1)
    _add_device(p)
    ns = p.parse_args(argv)
    device = _device(ns)
    if device is None:
        return 1
    from tsar_mvs_tpu_torch import pipeline
    fp = FusionParams(depth_diff=ns.depth_diff, normal_thresh_deg=ns.angle,
                      num_consistent=ns.num_consistent,
                      reproj_error=ns.reproj_error,
                      used_list=bool(ns.used_list))
    out = pipeline.fuse_scene(ns.scene_dir, fp, device=device)
    print(f"fused cloud: {out}")
    return 0


def cmd_synth(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.cli synth")
    p.add_argument("out_dir")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    ns = p.parse_args(argv)
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    root = make_scene(height=ns.height, width=ns.width, num_views=ns.views,
                      seed=ns.seed).export(ns.out_dir)
    print(f"synthetic scene written to {root}")
    return 0


def cmd_eval(argv: list[str]) -> int:
    """Depth (and normal) error against ground truth, or with --fscore the
    F-score of two .ply point clouds."""
    p = argparse.ArgumentParser(prog="tsar_mvs_tpu_torch.cli eval")
    p.add_argument("est", help="estimated depth .dmb/.pfm")
    p.add_argument("gt", help="ground-truth depth .dmb/.pfm")
    p.add_argument("--gtDepth_tolerance", type=float, default=1.0,
                   dest="tolerance")
    p.add_argument("--occl_mask", default=None)
    p.add_argument("--est_normal", default=None)
    p.add_argument("--gt_normal", default=None)
    p.add_argument("--fscore", action="store_true",
                   help="treat est/gt as .ply point clouds and report F1")
    p.add_argument("--threshold", type=float, default=0.02)
    ns = p.parse_args(argv)
    from tsar_mvs_tpu_torch import eval as ev
    from tsar_mvs_tpu_torch.utils.dmb import read_dmb
    from tsar_mvs_tpu_torch.utils.pfm import read_pfm
    from tsar_mvs_tpu_torch.utils.ply import read_ply
    from tsar_mvs_tpu_torch.utils.synthetic import read_png_gray

    if ns.fscore:
        r = ev.point_cloud_fscore(read_ply(ns.est)[0], read_ply(ns.gt)[0],
                                  threshold=ns.threshold)
        print(json.dumps({"precision": r.precision, "recall": r.recall,
                          "f1": r.f1, "threshold": r.threshold}))
        return 0

    def load(path):
        return read_pfm(path) if Path(path).suffix == ".pfm" \
            else read_dmb(path)

    occl = read_png_gray(ns.occl_mask) if ns.occl_mask else None
    r = ev.depth_error(load(ns.est), load(ns.gt), tolerance=ns.tolerance,
                       occl_mask=occl)
    out = {"error": r.error, "error_nocc": r.error_nocc,
           "error_valid": r.error_valid,
           "error_valid_all": r.error_valid_all,
           "abs_err_mean": r.abs_err_mean, "num_gt": r.num_gt,
           "num_valid": r.num_valid}
    if ns.est_normal and ns.gt_normal:
        nr = ev.normal_error(load(ns.est_normal), load(ns.gt_normal))
        out.update({"normal_mean_deg": nr.mean_deg,
                    "normal_median_deg": nr.median_deg})
    print(json.dumps(out))
    return 0


def cmd_bench(argv: list[str]) -> int:
    """The one-view benchmark (tsar_mvs_tpu_torch/bench.py)."""
    from tsar_mvs_tpu_torch import bench
    return bench.main(argv)


COMMANDS = {"gipuma": cmd_gipuma, "scene": cmd_scene, "view": cmd_view,
            "fuse": cmd_fuse, "synth": cmd_synth, "eval": cmd_eval,
            "bench": cmd_bench}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m tsar_mvs_tpu_torch.cli {"
              + ",".join(COMMANDS) + "} ...")
        return 0
    cmd = argv[0]
    if cmd in COMMANDS:
        return COMMANDS[cmd](argv[1:])
    from tsar_mvs_tpu_torch.pipeline import IMAGE_SUFFIXES
    if cmd.startswith("-") or Path(cmd).suffix in IMAGE_SUFFIXES:
        # A bare reference-style invocation (images and flags).
        return cmd_gipuma(argv)
    print(f"unknown command {cmd!r}; usage: python -m tsar_mvs_tpu_torch.cli"
          " {" + ",".join(COMMANDS) + "} ...", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
