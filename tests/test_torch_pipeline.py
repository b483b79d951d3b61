"""The slice as a whole: the port's process_view against the JAX
process_view (s-volume sampler) on conftest's 96x128x5 scene, exported to
disk, with tests/test_tsar.py's small-scene parameters.

The two packages draw different random numbers (init, refine draws,
RANSAC), so they are held to accuracy, not bits: the share of matchable
textured pixels within 2% of the ground-truth depth (bench.py's acc2)
agrees to 0.03, before and after refinement. The artifacts agree in
names, depth map shape and point count. Also: the CLI surface, and no
module of the port imports jax."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.utils import dmb, ply
from tsar_mvs_tpu.utils.synthetic import source_coverage

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


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Both process_view runs. The JAX TsarResult holds no PatchMatch depth,
    so its tsar_refine is wrapped to record the state it refines."""
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu.models import patchmatch as jpm
    from tsar_mvs_tpu.models import tsar as jtsar
    from tsar_mvs_tpu_torch import pipeline as tpipe
    seen = {}
    refine = jtsar.tsar_refine

    def recording_refine(imgs, cams, view_ids, params, state, *a, **kw):
        seen["depth_pm"] = np.asarray(jpm.depth_map(state, cams))
        return refine(imgs, cams, view_ids, params, state, *a, **kw)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtsar, "tsar_refine", recording_refine)
        root = scene.export(tmp_path_factory.mktemp("jax") / "scene")
        res = jpipe.process_view(jpipe.load_scene(root), 0,
                                 AlgorithmParams(ncc_impl="svolume",
                                                 **PARAMS))
        out["jax"] = (root, res, seen["depth_pm"])
    root = scene.export(tmp_path_factory.mktemp("torch") / "scene")
    res = tpipe.process_view(tpipe.load_scene(root), 0,
                             AlgorithmParams(**PARAMS), device="cpu")
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
    from tsar_mvs_tpu_torch import cli
    assert cli.main(["scene", str(tmp_path), "--fuse"]) == 2
    assert cli.main(["scene", str(tmp_path), "-color_processing"]) == 2
    assert cli.main(["sweep"]) == 2


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax."""
    code = (
        "import importlib, pkgutil, sys, json\n"
        "import tsar_mvs_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'tsar_mvs_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'mods': mods, 'jax': [k for k in sys.modules "
        "if k == 'jax' or k.startswith('jax.')]}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tsar_mvs_tpu_torch.pipeline" in res["mods"]
    assert "tsar_mvs_tpu_torch.ops.cuda_ncc" in res["mods"]
    assert res["jax"] == []
