"""The slice as a whole: the port's process_view against the JAX
process_view (s-volume sampler) on conftest's 96x128x5 scene, exported to
disk, with tests/test_tsar.py's small-scene parameters.

The two packages draw different random numbers (init, refine draws,
RANSAC), so they are held to accuracy, not bits: the share of matchable
textured pixels within 2% of the ground-truth depth (bench.py's acc2)
agrees to 0.03, before and after refinement. The artifacts agree in
names, depth map shape and point count. The APD-prior branch
(a noisy GT prior with its weak.png seed) is held the same way: with
pm_iterations=0 to 0.03 after refinement, with pm_iterations=2 (full-
resolution PatchMatch from the lifted prior) to 0.03 after PatchMatch
and after refinement; state_from_prior to atol 1e-5.
Also: the CLI surface, and no module of the port (nor chip_smoke) imports
jax or the JAX package."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.utils import display, dmb, ply
from tsar_mvs_tpu.utils.synthetic import source_coverage
from tsar_mvs_tpu_torch.config import AlgorithmParams as TorchParams

torch.set_num_threads(2)

PARAMS = dict(iterations=6, weak_text_num=25, hough_thr=12,
              min_line_length=12, max_line_gap=3, ransac_iters=2000,
              ransac_anneal_rounds=200, ransac_thr_base=0.005,
              ransac_thr_max=0.05, ransac_thr_step=0.002, wmf_drift_thr=2.0,
              wmf_iters=2, wmf_final_iters=3)


def _acc2(depth, scene, ref=0, src=(1, 2, 3, 4)):
    gt = scene.depth[ref]
    ok = np.isfinite(gt) & ~scene.weak_mask[ref]
    matchable = ok & (source_coverage(scene, ref=ref, src_views=src) >= 1)
    rel = np.abs(depth - gt) / np.where(np.isfinite(gt), gt, 1.0)
    return float((rel[matchable] < 0.02).mean())


class _Refined(Exception):
    pass


def jax_process_view(root, ref=0, params=None, refine=True, **kw):
    """JAX process_view (s-volume sampler, PARAMS unless `params` is
    given) on the scene at `root`, and the PatchMatch depth it refined:
    the JAX TsarResult holds none, so tsar_refine is wrapped to record
    the state it is given. With refine=False the run stops there and the
    result is None."""
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu.models import patchmatch as jpm
    from tsar_mvs_tpu.models import tsar as jtsar
    seen = {}
    tsar_refine = jtsar.tsar_refine

    def recording_refine(imgs, cams, view_ids, params, state, *a, **kw):
        seen["depth_pm"] = np.asarray(jpm.depth_map(state, cams))
        if not refine:
            raise _Refined
        return tsar_refine(imgs, cams, view_ids, params, state, *a, **kw)

    params = params or AlgorithmParams(ncc_impl="svolume", **PARAMS)
    res = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtsar, "tsar_refine", recording_refine)
        try:
            res = jpipe.process_view(jpipe.load_scene(root), ref, params,
                                     **kw)
        except _Refined:
            pass
    return res, seen["depth_pm"]


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Both process_view runs."""
    from tsar_mvs_tpu_torch import pipeline as tpipe
    out = {}
    root = scene.export(tmp_path_factory.mktemp("jax") / "scene")
    out["jax"] = (root, *jax_process_view(root))
    root = scene.export(tmp_path_factory.mktemp("torch") / "scene")
    res = tpipe.process_view(tpipe.load_scene(root), 0,
                             TorchParams(**PARAMS), device="cpu")
    out["torch"] = (root, res, res.depth_pm)
    return out


def test_process_view_accuracy_matches_jax(scene, runs):
    acc = {k: (_acc2(pm_depth, scene), _acc2(res.depth, scene))
           for k, (_, res, pm_depth) in runs.items()}
    assert abs(acc["torch"][0] - acc["jax"][0]) <= 0.03, acc
    assert abs(acc["torch"][1] - acc["jax"][1]) <= 0.03, acc
    assert acc["torch"][1] > 0.9, acc


def test_artifacts_match_jax(runs):
    jroot, troot = runs["jax"][0], runs["torch"][0]
    jdir = jroot / "results" / "00000000"
    tdir = troot / "results" / "00000000"
    assert sorted(p.name for p in tdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    for name in ("TSAR_disp.dmb", "TSAR_normals.dmb", "TSAR_slic_labels.dmb"):
        assert dmb.read_dmb(tdir / name).shape == \
            dmb.read_dmb(jdir / name).shape
    tpts = ply.read_ply(tdir / "TSAR_model.ply")[0]
    assert tpts.shape[0] == ply.read_ply(jdir / "TSAR_model.ply")[0].shape[0]
    assert tpts.shape[0] == 96 * 128
    assert np.isfinite(tpts).all()


def test_cli_view_writes_artifacts(scene, tmp_path):
    from tsar_mvs_tpu_torch import cli
    root = scene.export(tmp_path / "scene")
    assert cli.main(["view", str(root), "00000001", "--iterations", "1",
                     "--device", "cpu"]) == 0
    out = root / "results" / "00000001"
    assert dmb.read_dmb(out / "TSAR_disp.dmb").shape == (96, 128)
    assert (out / "TSAR_model.ply").exists()


def test_cli_scene_fuse_not_ported(tmp_path):
    """An unknown command exits 2 before touching the scene. (`scene
    --sharded on` and `bench` are ported: tests/test_torch_parallel.py::
    test_cli_scene_sharded_on_writes_artifacts and
    tests/test_torch_bench.py.)"""
    from tsar_mvs_tpu_torch import cli
    assert cli.main(["sweep"]) == 2
    assert not (tmp_path / "results").exists()


def test_port_imports_no_jax():
    """After importing every module of the port and chip_smoke in a fresh
    interpreter, neither jax nor tsar_mvs_tpu (nor any submodule of
    either) is loaded."""
    from pathlib import Path
    code = (
        "import importlib, pkgutil, sys, json\n"
        "import tsar_mvs_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'tsar_mvs_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps({'mods': mods, 'loaded': [k for k in sys.modules "
        "if k.split('.')[0] in ('jax', 'jaxlib', 'tsar_mvs_tpu')]}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=180,
                         cwd=Path(__file__).resolve().parents[1])
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("pipeline", "ops.cuda_ncc", "models.fusion", "config", "eval",
                "kernel_times", "models.weak_texture", "utils.synthetic",
                "utils.native", "parallel.mesh", "parallel.scene_sharded",
                "parallel.distributed", "bench", "bench_patchmatch",
                "bench_scaling"):
        assert f"tsar_mvs_tpu_torch.{mod}" in res["mods"]
    assert res["loaded"] == []


def write_prior(scene, root, ref=0, seed=0):
    """APD/<name>/ for view `ref`: GT depth with 0.5% noise and 5% of its
    pixels redrawn within +-30% (weak.png 0 there), GT world normals."""
    rng = np.random.default_rng(seed)
    gt = scene.depth[ref]
    prior = gt * (1.0 + 0.005 * rng.standard_normal(gt.shape))
    redraw = rng.random(gt.shape) < 0.05
    prior = np.where(redraw, gt * rng.uniform(0.7, 1.3, gt.shape), prior)
    apd = root / "APD" / f"{ref:08d}"
    apd.mkdir(parents=True)
    dmb.write_dmb(apd / "depths_geom.dmb", prior.astype(np.float32))
    dmb.write_dmb(apd / "normals.dmb",
                  scene.normal_world[ref].astype(np.float32))
    display.write_png(apd / "weak.png",
                      np.where(redraw, 0, 255).astype(np.uint8))
    return prior


def test_apd_prior_matches_jax(scene, runs, tmp_path):
    """process_view from a noisy GT prior with pm_iterations=0 (lift,
    reliability seed, refinement; no PatchMatch), JAX against the port:
    acc2 after refinement within 0.03. Depends on `runs` so the JAX
    refinement programs are compiled already."""
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu_torch import pipeline as tpipe
    acc = {}
    for key, pipe, kw in (
            ("jax", jpipe, dict(params=AlgorithmParams(ncc_impl="svolume",
                                                       **PARAMS))),
            ("torch", tpipe, dict(params=TorchParams(**PARAMS),
                                  device="cpu"))):
        root = scene.export(tmp_path / key / "scene")
        prior = write_prior(scene, root)
        res = pipe.process_view(pipe.load_scene(root), 0, pm_iterations=0,
                                out_dir=tmp_path / key / "out", **kw)
        assert (tmp_path / key / "out" / "TSAR_disp.dmb").exists()
        acc[key] = _acc2(res.depth, scene)
    acc["prior"] = _acc2(prior, scene)
    assert abs(acc["torch"] - acc["jax"]) <= 0.03, acc
    assert acc["torch"] > 0.9, acc


def test_apd_prior_patchmatch_matches_jax(scene, runs, tmp_path):
    """process_view from the noisy GT prior with pm_iterations=2: two
    full-resolution PatchMatch iterations from the lifted planes, then
    refinement. JAX against the port: acc2 after PatchMatch and after
    refinement each within 0.03; at this size (2 px plane spacing) both
    keep the prior's accuracy. Depends on `runs` so the JAX refinement
    programs are compiled already."""
    from tsar_mvs_tpu_torch import pipeline as tpipe
    acc = {}
    root = scene.export(tmp_path / "jax" / "scene")
    prior = write_prior(scene, root)
    res, depth_pm = jax_process_view(root, pm_iterations=2,
                                     out_dir=tmp_path / "jax" / "out")
    acc["jax"] = (_acc2(depth_pm, scene), _acc2(res.depth, scene))
    root = scene.export(tmp_path / "torch" / "scene")
    write_prior(scene, root)
    res = tpipe.process_view(tpipe.load_scene(root), 0,
                             TorchParams(**PARAMS), pm_iterations=2,
                             out_dir=tmp_path / "torch" / "out",
                             device="cpu")
    acc["torch"] = (_acc2(res.depth_pm, scene), _acc2(res.depth, scene))
    acc["prior"] = _acc2(prior, scene)
    assert abs(acc["torch"][0] - acc["jax"][0]) <= 0.03, acc
    assert abs(acc["torch"][1] - acc["jax"][1]) <= 0.03, acc
    assert min(acc["torch"]) > acc["prior"] - 0.02, acc


def test_state_from_prior_matches_jax(scene):
    from tsar_mvs_tpu import geometry as jgeo
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu.models import patchmatch as jpm
    from tsar_mvs_tpu_torch import convert
    from tsar_mvs_tpu_torch.models import patchmatch as pm
    jc = jgeo.build_camera_set(list(scene.P[[1, 0, 2]]),
                               depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    depth = scene.depth[1].astype(np.float32)
    normal = scene.normal_world[1].astype(np.float32)
    j = jpm.state_from_prior(depth, normal, jc, jpipe._stats_stub(
        jgeo.pixel_rays(jc, *depth.shape)))
    t = pm.state_from_prior(torch.as_tensor(depth), torch.as_tensor(normal),
                            convert.camera_set(jc, "cpu"))
    for field in pm.PlaneState._fields:
        jv, tv = np.asarray(getattr(j, field)), getattr(t, field).numpy()
        assert tv.dtype == jv.dtype, field
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5, err_msg=field)
    # The lifted planes reproduce the prior depth.
    np.testing.assert_allclose(
        pm.depth_map(t, convert.camera_set(jc, "cpu")), depth, rtol=1e-4)
