"""The port's own copies of the host-side modules (config, eval,
models/weak_texture, utils/*) against the JAX package's, on the CPU with
inputs from a numpy seed: same defaults, files written by one side read
back equal by the other, equal synthetic scenes, equal weak-texture
regions, equal metrics (the F-score to 1e-6: a k-d tree may break distance
ties in another order). Also: the port's entry points default to the card
and raise without one."""

import dataclasses

import numpy as np
import pytest
import torch

from tsar_mvs_tpu import config as jconfig
from tsar_mvs_tpu import eval as jeval
from tsar_mvs_tpu.models import weak_texture as jwt
from tsar_mvs_tpu.utils import display as jdisplay
from tsar_mvs_tpu.utils import dmb as jdmb
from tsar_mvs_tpu.utils import pfm as jpfm
from tsar_mvs_tpu.utils import ply as jply
from tsar_mvs_tpu.utils import scene_io as jio
from tsar_mvs_tpu.utils import synthetic as jsyn
from tsar_mvs_tpu_torch import config as tconfig
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch import eval as teval
from tsar_mvs_tpu_torch.models import weak_texture as twt
from tsar_mvs_tpu_torch.utils import display as tdisplay
from tsar_mvs_tpu_torch.utils import dmb as tdmb
from tsar_mvs_tpu_torch.utils import pfm as tpfm
from tsar_mvs_tpu_torch.utils import ply as tply
from tsar_mvs_tpu_torch.utils import scene_io as tio
from tsar_mvs_tpu_torch.utils import synthetic as tsyn

# Fields of the JAX AlgorithmParams that only its TPU kernel's
# tile-blocked refine draws read.
NOT_CARRIED = {"refine_block_frac"}


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["AlgorithmParams", "FusionParams"])
def test_params_defaults_and_convert(name):
    """Every field the port keeps has the JAX package's default, the port
    drops only NOT_CARRIED, and convert carries non-default values
    across."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jd, td = _defaults(jcls), _defaults(tcls)
    assert set(jd) - set(td) == (NOT_CARRIED if name == "AlgorithmParams"
                                 else set())
    assert set(td) <= set(jd)
    assert {k: jd[k] for k in td} == td
    to_port = (convert.algorithm_params if name == "AlgorithmParams"
               else convert.fusion_params)
    assert to_port(jcls()) == tcls()
    # Non-default values of every shared field survive the conversion.
    changed = {}
    for k, v in td.items():
        changed[k] = (not v if isinstance(v, bool)
                      else v + 1 if isinstance(v, (int, float)) else v)
    src = jcls(**changed)
    assert dataclasses.asdict(to_port(src)) == changed
    assert to_port(to_port(src)) == to_port(src)
    if name == "AlgorithmParams":
        a = jcls().with_depth_range(0.5, 3.0, 700.0)
        b = tcls().with_depth_range(0.5, 3.0, 700.0)
        assert to_port(a) == b and (a.hrad, a.vrad) == (b.hrad, b.vrad)


def _pairs():
    """(writer's modules..., reader's modules...) for both directions."""
    return [(jdmb, jpfm, jply, jio, jdisplay, jsyn,
             tdmb, tpfm, tply, tio, tsyn),
            (tdmb, tpfm, tply, tio, tdisplay, tsyn,
             jdmb, jpfm, jply, jio, jsyn)]


@pytest.mark.parametrize("direction", [0, 1])
def test_files_cross_read(tmp_path, rng, direction):
    """dmb (depth and normals), pfm (gray and colour), ply, png, cam and
    pair files written by one package read back equal by the other."""
    (wdmb, wpfm, wply, wio, wdisp, wsyn,
     rdmb, rpfm, rply, rio, rsyn) = _pairs()[direction]
    depth = rng.uniform(0.5, 3.0, (17, 23)).astype(np.float32)
    normals = rng.standard_normal((17, 23, 3)).astype(np.float32)
    wdmb.write_dmb(tmp_path / "d.dmb", depth)
    wdmb.write_dmb(tmp_path / "n.dmb", normals)
    np.testing.assert_array_equal(rdmb.read_dmb(tmp_path / "d.dmb"), depth)
    np.testing.assert_array_equal(rdmb.read_dmb(tmp_path / "n.dmb"), normals)
    wpfm.write_pfm(tmp_path / "g.pfm", depth)
    wpfm.write_pfm(tmp_path / "c.pfm", normals)
    np.testing.assert_array_equal(rpfm.read_pfm(tmp_path / "g.pfm"), depth)
    np.testing.assert_array_equal(rpfm.read_pfm(tmp_path / "c.pfm"), normals)

    pts = rng.standard_normal((50, 3)).astype(np.float32)
    nrm = rng.standard_normal((50, 3)).astype(np.float32)
    col = rng.integers(0, 256, 50).astype(np.uint8)
    wply.write_ply(tmp_path / "m.ply", pts, nrm, col)
    got = rply.read_ply(tmp_path / "m.ply")
    own = wply.read_ply(tmp_path / "m.ply")
    for g, o in zip(got, own):
        np.testing.assert_array_equal(g, o)
    np.testing.assert_array_equal(got[0], pts)

    gray = rng.integers(0, 256, (17, 23)).astype(np.uint8)
    wdisp.write_png(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(rsyn.read_png_gray(tmp_path / "g.png"),
                                  wsyn.read_png_gray(tmp_path / "g.png"))
    np.testing.assert_array_equal(
        np.asarray(rsyn.read_png_gray(tmp_path / "g.png")), gray)

    R, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    cam = wio.CamFile(R=R, t=rng.standard_normal(3),
                      K=np.array([[700.0, 0, 64], [0, 690.0, 48], [0, 0, 1]]),
                      depth_min=0.4, depth_interval=0.01, depth_num=192,
                      depth_max=2.32)
    wio.write_cam_file(tmp_path / "c_cam.txt", cam)
    a, b = rio.read_cam_file(tmp_path / "c_cam.txt"), \
        wio.read_cam_file(tmp_path / "c_cam.txt")
    for f in ("R", "t", "K", "P"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.depth_min, a.depth_max, a.depth_num, a.depth_interval) == \
        (b.depth_min, b.depth_max, b.depth_num, b.depth_interval)
    np.testing.assert_allclose(a.P, cam.P, rtol=1e-6)

    pair = wio.PairFile(neighbors={0: [(1, 2.5), (2, 1.25)],
                                   1: [(0, 2.5)], 2: [(0, 1.25), (1, 0.5)]})
    wio.write_pair_file(tmp_path / "pair.txt", pair)
    got = rio.read_pair_file(tmp_path / "pair.txt")
    assert got.neighbors == wio.read_pair_file(tmp_path / "pair.txt").neighbors
    assert got.source_ids(2, 1) == pair.source_ids(2, 1) == [0]


def test_make_scene_workers_equal():
    """The views rendered in spawned processes equal the serial render, bit
    for bit, with noise drawn in view order after them."""
    kw = dict(height=40, width=56, num_views=3, seed=1, noise_sigma=2.0,
              geometry_jitter=0.5)
    a, b = tsyn.make_scene(**kw), tsyn.make_scene(workers=2, **kw)
    for f in dataclasses.fields(tsyn.SyntheticScene):
        np.testing.assert_array_equal(getattr(b, f.name), getattr(a, f.name),
                                      err_msg=f.name)


@pytest.mark.parametrize("kw", [dict(height=48, width=64, num_views=3,
                                     seed=3),
                                dict(height=40, width=56, num_views=4,
                                     seed=1, geometry_jitter=0.5)])
def test_make_scene_equal(kw, tmp_path):
    """Equal arrays from the same seed, equal exports, equal coverage and
    GT cloud (the port's gt_cloud against the one of
    scripts/validate_synthetic.py)."""
    import importlib.util
    from pathlib import Path
    j, t = jsyn.make_scene(**kw), tsyn.make_scene(**kw)
    for f in dataclasses.fields(jsyn.SyntheticScene):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name),
                                      err_msg=f.name)
    np.testing.assert_array_equal(tsyn.source_coverage(t, ref=0),
                                  jsyn.source_coverage(j, ref=0))
    jroot, troot = j.export(tmp_path / "j"), t.export(tmp_path / "t")
    for p in sorted(q.relative_to(jroot) for q in jroot.rglob("*")
                    if q.is_file()):
        assert (troot / p).read_bytes() == (jroot / p).read_bytes(), p
    spec = importlib.util.spec_from_file_location(
        "validate_synthetic", Path(__file__).resolve().parents[1]
        / "scripts" / "validate_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(tsyn.gt_cloud(t), mod.gt_cloud(j))


def test_weak_texture_equal(scene):
    """Equal regions and masks on conftest's scene with the pipeline
    test's detector thresholds, and with the defaults."""
    small = dict(weak_text_num=25, hough_thr=12, min_line_length=12,
                 max_line_gap=3)
    for kw in (small, {}):
        jp = jconfig.AlgorithmParams(**kw)
        for view in (0, 1):
            gray = scene.images[view]
            j = jwt.detect_weak_texture(gray, jp)
            t = twt.detect_weak_texture(gray, convert.algorithm_params(jp))
            for f in dataclasses.fields(jwt.WeakTexture):
                np.testing.assert_array_equal(getattr(t, f.name),
                                              getattr(j, f.name),
                                              err_msg=f.name)
            assert t.num_regions == j.num_regions
    assert j.num_regions > 0
    np.testing.assert_array_equal(twt.roberts(gray), jwt.roberts(gray))
    np.testing.assert_array_equal(twt.pyr_down(gray), jwt.pyr_down(gray))


def test_eval_metrics_equal(scene, rng):
    gt = np.where(np.isfinite(scene.depth[0]), scene.depth[0], 0.0)
    est = gt * (1.0 + 0.05 * rng.standard_normal(gt.shape))
    est[::7, ::5] = 0.0
    occl = np.where(rng.random(gt.shape) < 0.1, 128, 255).astype(np.uint8)
    for kw in (dict(tolerance=0.05), dict(tolerance=0.02, occl_mask=occl)):
        jr, tr = jeval.depth_error(est, gt, **kw), \
            teval.depth_error(est, gt, **kw)
        for f in dataclasses.fields(jr):
            np.testing.assert_array_equal(getattr(tr, f.name),
                                          getattr(jr, f.name),
                                          err_msg=f.name)
    n_gt = scene.normal_world[0]
    n_est = n_gt + 0.1 * rng.standard_normal(n_gt.shape)
    jn, tn = jeval.normal_error(n_est, n_gt), teval.normal_error(n_est, n_gt)
    for f in dataclasses.fields(jn):
        np.testing.assert_array_equal(getattr(tn, f.name),
                                      getattr(jn, f.name), err_msg=f.name)
    cloud = tsyn.gt_cloud(scene)
    noisy = cloud[::3] + 0.01 * rng.standard_normal(cloud[::3].shape)
    jf = jeval.point_cloud_fscore(noisy, cloud, threshold=0.02)
    tf = teval.point_cloud_fscore(noisy, cloud, threshold=0.02)
    for f in dataclasses.fields(jf):
        assert abs(getattr(tf, f.name) - getattr(jf, f.name)) <= 1e-6, f.name
    assert 0.0 < tf.f1 < 1.0


def test_display_equal(scene, tmp_path):
    """The visualisation helpers and the parameter dump agree."""
    depth = np.where(np.isfinite(scene.depth[0]), scene.depth[0], 0.0)
    np.testing.assert_array_equal(
        tdisplay.disparity_for_display(depth),
        jdisplay.disparity_for_display(depth))
    n = scene.normal_world[0]
    np.testing.assert_array_equal(
        tdisplay.add_sphere_legend(tdisplay.normals_for_display(n)),
        jdisplay.add_sphere_legend(jdisplay.normals_for_display(n)))
    jp = jconfig.AlgorithmParams(iterations=3)
    jdisplay.write_parameters_file(tmp_path / "j.txt", jp)
    tdisplay.write_parameters_file(tmp_path / "t.txt",
                                   convert.algorithm_params(jp))
    jl = (tmp_path / "j.txt").read_text().splitlines()
    tl = (tmp_path / "t.txt").read_text().splitlines()
    assert [ln for ln in jl if ln.split()[0] not in NOT_CARRIED] == tl


def test_entry_points_default_to_the_card(scene, tmp_path, monkeypatch):
    """process_view, process_scene, fuse_scene and run_slic_stage without
    a `device` ask for the card; on a machine without one they raise and
    write nothing."""
    from tsar_mvs_tpu_torch import pipeline as tpipe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = scene.export(tmp_path / "scene")
    before = sorted(p.relative_to(root) for p in root.rglob("*"))
    loaded = tpipe.load_scene(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.process_view(loaded, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.process_scene(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_slic_stage(scene.images[0], tconfig.AlgorithmParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.fuse_scene(root, device="cuda")
    assert sorted(p.relative_to(root) for p in root.rglob("*")) == before
    assert tpipe.resolve_device("cpu") == torch.device("cpu")
