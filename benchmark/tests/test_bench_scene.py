"""The benchmark's card-side render against the program's numpy scene.

CPU only: ``benchmark.scene.make_scene`` on the CPU against
``tsar_mvs_tpu_torch.utils.synthetic.make_scene`` (geometry_jitter 0,
planar weak patch, no noise) at two sizes and three seeds, one of them
above 2**31 as the harness's seeds are.
"""

import numpy as np
import pytest

from benchmark import scene as bench_scene
from tsar_mvs_tpu_torch.utils.synthetic import make_scene


@pytest.mark.parametrize("height,width", [(96, 128), (160, 224)])
@pytest.mark.parametrize("seed", [0, 7, 3000000019])
def test_render_matches_program_scene(height, width, seed):
    ref = make_scene(height=height, width=width, num_views=5, seed=seed)
    got = bench_scene.make_scene(height, width, 5, seed, "cpu")
    img = got.images.numpy()
    # Images: float64 sums in another order can move a lattice
    # coordinate across an integer, and then the hash's floor picks
    # another cell at that pixel; allow such pixels, one in 10^4.
    off = np.abs(img - ref.images) > 1e-3
    assert off.mean() <= 1e-4
    # Depth: the program keeps float32 depths, the render float64; the
    # float32 rounding is 2**-24 relative, 6e-8.
    fin = np.isfinite(ref.depth)
    depth = got.depth.numpy()
    assert (np.isfinite(depth) == fin).all()
    assert (np.abs(depth[fin] - ref.depth[fin]) / ref.depth[fin]).max() \
        <= 2e-7
    # Normals: a rectangle's unit normal, float32 in the program.
    assert np.abs(got.normal_world.numpy() - ref.normal_world).max() <= 1e-7
    assert (got.weak_mask.numpy() == ref.weak_mask).mean() >= 1 - 1e-4
    # The depth range is taken from the float32 depths on both sides.
    assert got.depth_min == pytest.approx(ref.depth_min, rel=1e-12)
    assert got.depth_max == pytest.approx(ref.depth_max, rel=1e-12)
    np.testing.assert_allclose(got.P, ref.P, rtol=0, atol=0)


def test_pair_ranking_matches_export(tmp_path):
    """The in-memory pair ranking is what `export` writes to pair.txt."""
    from tsar_mvs_tpu_torch.utils.scene_io import read_pair_file
    ref = make_scene(height=48, width=64, num_views=6, seed=1)
    ref.export(tmp_path, pair_top_k=4)
    pair = read_pair_file(tmp_path / "pair.txt")
    got = bench_scene.pair_ranking(ref.R, ref.t, 4)
    assert {v: [j for j, _ in n] for v, n in got.items()} == \
        {v: [j for j, _ in n] for v, n in pair.neighbors.items()}


# sha256 of make_scene's images (float32), depth and normals (float64) and
# textureless mask (bool), in that order, at 96x128 with each gray
# configuration's scene settings and views, computed with the renderer
# before it learned colour: the gray path renders the same scene to the
# bit.
GRAY_SCENES = {
    "eth3d-2k":
        "a31d69934df16d3c2032b9cf16bda3d8150e15eda551a0b5f21d4526dc73cc69",
    "middlebury-dino":
        "971f009d47b99efe54c60eec28991da04f26b10d731bd0450fd9017210522dfb",
    "eth3d-2k-courtyard":
        "9f3740682507f72bbd22fa27a25ea9c48f904b36d1b063e4bec228e5e8c20d87"}


def _config(name: str) -> dict:
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    return json.loads((root / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def _small_scene(cfg: dict, color: bool | None = None, views=None):
    geo = cfg["scene"]
    return bench_scene.make_scene(
        96, 128, views or cfg["images"], geo["texture_seed"], "cpu",
        weak_fraction=geo["weak_fraction"], arc_radius=geo["arc_radius"],
        arc_span_deg=geo["arc_span_deg"], pair_top_k=cfg["pair_top_k"],
        color=geo.get("color", False) if color is None else color)


@pytest.mark.parametrize("name", sorted(GRAY_SCENES))
def test_gray_scene_is_unchanged(name):
    import hashlib
    cfg = _config(name)
    assert "color" not in cfg["scene"]
    sd = _small_scene(cfg)
    assert sd.images_color is None
    h = hashlib.sha256()
    for t in (sd.images, sd.depth, sd.normal_world, sd.weak_mask):
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == GRAY_SCENES[name]


def test_color_scene():
    """The colour configuration's scene: gray is the luma of the colour
    images to float32 rounding and the gray scene's texture, the channels
    differ, the textureless patch is flat in every channel, and the truth
    is the gray scene's."""
    import torch
    cfg = _config("eth3d-2k-color3")
    assert cfg["scene"]["color"] is True
    rgb_scene = _small_scene(cfg)
    gray_scene = _small_scene(cfg, color=False)
    rgb = rgb_scene.images_color
    assert rgb.shape == (cfg["images"], 3, 96, 128)
    assert rgb.dtype == torch.float32
    # Inside the range, so no clamp breaks the luma.
    assert float(rgb.min()) > 0 and float(rgb.max()) < 255
    c = rgb.double()
    luma = 0.299 * c[:, 0] + 0.587 * c[:, 1] + 0.114 * c[:, 2]
    # float32 channels and a float32 luma: a few ulps at 255.
    assert float((rgb_scene.images.double() - luma).abs().max()) <= 1e-4
    assert float((rgb_scene.images - gray_scene.images).abs().max()) <= 1e-4
    # The chroma noises make the channels differ on the textured pixels
    # (by 6.6 levels on the mean at this size), correlated as a photo's.
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert float((c[:, a] - c[:, b]).abs().mean()) > 3.0
        corr = torch.corrcoef(torch.stack([c[:, a].flatten(),
                                           c[:, b].flatten()]))[0, 1]
        assert 0.5 < float(corr) < 0.99
    # Where the gray scene's patch is flat (its albedo to float32, the
    # texture's weight 0 or all but 0), every channel and the luma hold
    # the same albedo; at this size that is 30% of the mask, whose rim
    # still blends in some texture.
    albedo = torch.tensor(0.62 * 255.0, dtype=torch.float64).float()
    flat = gray_scene.images == albedo
    assert flat.sum() >= 0.25 * gray_scene.weak_mask.sum() > 0
    for img in (rgb[:, 0], rgb[:, 1], rgb[:, 2], rgb_scene.images):
        assert float((img[flat] - albedo).abs().max()) <= 1e-3
    for key in ("depth", "normal_world", "weak_mask"):
        assert torch.equal(getattr(rgb_scene, key), getattr(gray_scene, key))
    assert (rgb_scene.depth_min, rgb_scene.depth_max, rgb_scene.pair) == (
        gray_scene.depth_min, gray_scene.depth_max, gray_scene.pair)


def test_color_cell_runs_on_the_cpu(monkeypatch):
    """A small copy of `eth3d2k.color3` through `run.run_cell` on the CPU
    is correct: the colour images reach the pyramid from memory (no image
    file is ever looked for), three distinct channels a view."""
    import time
    import torch
    from benchmark import run
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.models import patchmatch as pm

    def no_file(self, name):
        raise AssertionError(f"image file of view {name} looked for")
    monkeypatch.setattr(pipeline.Scene, "_image_path", no_file)
    seen = []
    real = pm.run_patchmatch_pyramid

    def record(*a, imgs_color=None, **k):
        seen.append(imgs_color)
        return real(*a, imgs_color=imgs_color, **k)
    monkeypatch.setattr(pm, "run_patchmatch_pyramid", record)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    _, _, config = run.load_cell("eth3d2k.color3")
    small = dict(config, resolution=[128, 96], images=3,
                 sources_per_view=2,
                 algorithm=dict(config["algorithm"], iterations=2,
                                wmf_iters=2, wmf_final_iters=2))
    # This size's own limits, as benchmark/tests/test_bench_faults.py's
    # for the gray images mix (sound runs read tex_bad2_mean 0.069-0.072,
    # _max 0.079-0.085, median error 0.0011-0.0015, best view's 25th
    # percentile 0.00029-0.00034, normals 4.6-7.0 degrees).
    limits = {k: {"limit": v} for k, v in (
        ("tex_bad2_mean", 0.2), ("tex_bad2_max", 0.2),
        ("tex_err_med", 0.003), ("tex_err_p25_min", 0.0012),
        ("tex_nrm_med_deg", 10.0), ("views_missing", 0))}
    try:
        res = run.run_cell("eth3d2k.color3", 3000000017, 0.0, False,
                           device="cpu", config=small, limits=limits,
                           t_start=time.perf_counter(), min_views=3)
    finally:
        torch.set_num_threads(before)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 3
    assert len(seen) == res["attempted"] + 1  # the warm-up view too
    for imgs_color in seen:
        assert imgs_color is not None and imgs_color.shape[1] == 3
        assert not torch.equal(imgs_color[:, 0], imgs_color[:, 1])
