"""Command line of the port, with the JAX CLI's flag names:

    python -m tsar_mvs_tpu_torch.cli view <scene_dir> <ref> [--device cuda]
    python -m tsar_mvs_tpu_torch.cli scene <scene_dir> [--device cuda]

Fusion (`scene --fuse`) and color matching (`scene -color_processing`)
are not ported yet; asking for them exits with status 2.
"""

from __future__ import annotations

import argparse
import sys

import torch

from tsar_mvs_tpu.config import AlgorithmParams


def _alg_params(ns) -> AlgorithmParams:
    kw = {}
    if ns.blocksize:
        kw["box_hsize"] = kw["box_vsize"] = ns.blocksize
    for field in ("iterations", "cam_scale", "max_views", "border_check_thr",
                  "iterations_fine", "prop_banks_fine"):
        v = getattr(ns, field, None)
        if v is not None:
            kw[field] = v
    if getattr(ns, "no_border_check", False):
        kw["border_check"] = False
    return AlgorithmParams(**kw)


def _parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("scene_dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--blocksize", type=int, default=None)
    p.add_argument("--device",
                   default="cuda" if torch.cuda.is_available() else "cpu")
    return p


def _not_ported(what: str) -> int:
    print(f"{what} is not ported yet", file=sys.stderr)
    return 2


def cmd_view(argv: list[str]) -> int:
    p = _parser("tsar_mvs_tpu_torch.cli view")
    p.add_argument("ref", help="view index or name")
    ns = p.parse_args(argv)
    from tsar_mvs_tpu_torch import pipeline
    scene = pipeline.load_scene(ns.scene_dir)
    ref_idx = (int(ns.ref) if ns.ref.isdigit()
               else scene.names.index(ns.ref))
    pipeline.process_view(scene, ref_idx, _alg_params(ns),
                          device=ns.device)
    return 0


def cmd_scene(argv: list[str]) -> int:
    p = _parser("tsar_mvs_tpu_torch.cli scene")
    p.add_argument("--cam_scale", type=float, default=None)
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-ply", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip views whose TSAR_disp.dmb already exists")
    p.add_argument("--fuse", action="store_true",
                   help="run fusion after all views (not ported yet)")
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
                   action="store_true", help="not ported yet")
    ns = p.parse_args(argv)
    if ns.fuse:
        return _not_ported("fusion")
    if ns.color_processing:
        return _not_ported("color processing")
    from tsar_mvs_tpu_torch import pipeline
    pipeline.process_scene(ns.scene_dir, _alg_params(ns), seed=ns.seed,
                           write_ply=not ns.no_ply, resume=ns.resume,
                           device=ns.device)
    return 0


COMMANDS = {"view": cmd_view, "scene": cmd_scene}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m tsar_mvs_tpu_torch.cli {view,scene} ...")
        return 0 if not argv or argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
