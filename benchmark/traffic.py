"""The one traffic generator: reads a mix from ``traffic/<name>.json``.

Every mix is a closed loop with one caller (a user running ``tsar
scene``) that sends the reference views in rotation, 0..V-1, repeated.
A mix states whether every view comes with an APD-style prior (`prior`:
noise, share of redrawn pixels and their range, written in set-up as
``<root>/APD/<name>/{depths_geom.dmb, normals.dmb, weak.png}``) and the
PatchMatch iterations asked for (`pm_iterations`, null for the program's
default). Every seed gets the same images and the same sequence of
views; the seed moves only the program's draws (each view's generator)
and the prior's noise.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.reference import truth

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def view_order(num_views: int, index: int) -> int:
    """The reference view of the loop's `index`-th request."""
    return index % num_views


def view_seed(seed: int, index: int) -> int:
    """The generator seed of the loop's `index`-th request (as
    process_scene seeds view i: seed * 1000003 + i), in 63 bits."""
    return (seed * 1000003 + index) % (1 << 63)


def write_priors(mix: dict, scene, names: list[str], root: Path,
                 seed: int) -> None:
    """APD-MVS's output contract for every view, made from the truth:
    depth with `noise` relative Gaussian noise, a `redraw_share` of the
    pixels redrawn uniformly within [redraw_low, redraw_high] times the
    truth (0 where no surface is hit), true normals, and weak.png 0 on
    the redrawn pixels and 255 elsewhere (chip_smoke.py phase 7's
    recipe). Drawn on the device from `seed` and the view."""
    prior = mix["prior"]
    dev = scene.depth.device
    for v, name in enumerate(names):
        g = torch.Generator(device=dev).manual_seed(
            (seed * 1000003 + 500009 * (v + 1)) % (1 << 63))
        gt = scene.depth[v]
        noisy = gt * (1.0 + prior["noise"] * torch.randn(
            gt.shape, generator=g, device=dev, dtype=gt.dtype))
        redraw = torch.rand(gt.shape, generator=g, device=dev,
                            dtype=gt.dtype) < prior["redraw_share"]
        lo, hi = prior["redraw_low"], prior["redraw_high"]
        scale = lo + (hi - lo) * torch.rand(gt.shape, generator=g,
                                            device=dev, dtype=gt.dtype)
        depth = torch.where(redraw, gt * scale, noisy)
        depth = torch.where(torch.isfinite(depth), depth, 0.0)
        out = root / "APD" / name
        out.mkdir(parents=True, exist_ok=True)
        truth.write_dmb(out / "depths_geom.dmb", depth.float().cpu().numpy())
        truth.write_dmb(out / "normals.dmb",
                        scene.normal_world[v].float().cpu().numpy())
        truth.write_png_gray(out / "weak.png",
                             torch.where(redraw, 0, 255).cpu().numpy())
