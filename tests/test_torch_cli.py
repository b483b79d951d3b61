"""The port's command line, in-process, on make_scene(48, 64, 3, seed=3)
(1 PatchMatch iteration where a view runs): the JAX CLI's commands and
flag names, what the reference scripts pass, and the device rule (no
silent CPU fallback: without CUDA, --device cpu must be given).

Tolerances: fuse against fusion.fuse on the same inputs, the same point
count exactly (one code path); eval of a depth map against itself, error
0 and F1 1.0 exactly; the bounding volume against the JAX CLI's, float64
rtol 1e-12."""

import json

import numpy as np
import pytest
import torch

from tsar_mvs_tpu.utils import dmb, ply
from tsar_mvs_tpu_torch import cli
from tsar_mvs_tpu_torch.config import FusionParams

torch.set_num_threads(2)
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def small():
    from tsar_mvs_tpu.utils.synthetic import make_scene
    return make_scene(height=48, width=64, num_views=3, seed=3)


@pytest.fixture
def root(small, tmp_path):
    return small.export(tmp_path / "scene")


def write_gt_results(small, root):
    """GT depth and world normals as every view's TSAR_*.dmb."""
    for v in range(small.num_views):
        out = root / "results" / f"{v:08d}"
        out.mkdir(parents=True, exist_ok=True)
        dmb.write_dmb(out / "TSAR_disp.dmb", small.depth[v].astype(np.float32))
        dmb.write_dmb(out / "TSAR_normals.dmb",
                      small.normal_world[v].astype(np.float32))


def test_gipuma_reference_script_line(root):
    """tests/test_cli_script_line.py's courtyard.sh-style line, verbatim
    (positional images, -mslp_folder/-images_folder/-krt_file/
    -output_folder/-no_display, equals-style flags, the empty `--min_angle=`
    of unset shell variables), plus the explicit device."""
    imgs = sorted(p.name for p in (root / "images").iterdir())
    argv = ["gipuma"] + list(imgs) + [
        "-mslp_folder", str(root),
        "-images_folder", str(root / "images"),
        "-krt_file", "dino_par.txt",
        "-output_folder", str(root / "results"),
        "-no_display", "--cam_scale=1", "--iterations=1",
        "--blocksize=11", "--cost_gamma=10", "--cost_comb=best_n",
        "--n_best=1", "--min_angle=", "--max_angle="] + CPU
    assert cli.main(argv) == 0
    out = root / "results" / imgs[0].split(".")[0]
    assert dmb.read_dmb(out / "TSAR_disp.dmb").shape == (48, 64)
    assert (out / "TSAR_normals.dmb").exists()
    assert not (out / "TSAR_normals.png").exists()


def test_bare_invocation_runs_gipuma(small, root, capsys):
    """Images first, no command: the reference binary's command line.
    Unknown flags warn; -gt/-gt_normal print the GT errors."""
    gt = root.parent / "gt.dmb"
    gtn = root.parent / "gt_normal.dmb"
    dmb.write_dmb(gt, small.depth[1].astype(np.float32))
    dmb.write_dmb(gtn, small.normal_world[1].astype(np.float32))
    argv = ["00000001.png", "00000000.png", "00000002.png",
            "-mslp_folder", str(root), "-no_display", "--iterations=1",
            "--frobnicate=3", "-gt", str(gt), "-gt_normal", str(gtn),
            "--gtDepth_tolerance=0.1"] + CPU
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "unknown option --frobnicate=3" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == {"error", "error_nocc", "error_valid",
                        "normal_mean_deg"}
    assert (root / "results" / "00000001" / "TSAR_disp.dmb").exists()


def test_gipuma_pmvs_folder(small, root, tmp_path):
    """--pmvs_folder: images from visualize/, Strecha P matrices from
    txt/, --camera_idx picks the reference (tests/test_cli_pmvs.py)."""
    pmvs = tmp_path / "pmvs"
    (pmvs / "visualize").mkdir(parents=True)
    (pmvs / "txt").mkdir()
    for i, png in enumerate(sorted((root / "images").glob("*.png"))):
        (pmvs / "visualize" / png.name).write_bytes(png.read_bytes())
        rows = "\n".join(" ".join(f"{v:.10g}" for v in row)
                         for row in small.P[i])
        (pmvs / "txt" / f"{png.stem}.P").write_text(rows + "\n")
    argv = ["gipuma", "--pmvs_folder", str(pmvs), "--camera_idx", "1",
            "-mslp_folder", str(root),
            "-output_folder", str(tmp_path / "results"),
            "-no_display", "--iterations=1",
            "--depth_min", f"{small.depth_min}",
            "--depth_max", f"{small.depth_max}"] + CPU
    assert cli.main(argv) == 0
    assert (tmp_path / "results" / "00000001" / "TSAR_disp.dmb").exists()


def test_bounding_volume_matches_jax(root, tmp_path):
    from tsar_mvs_tpu import cli as jcli
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu_torch import pipeline as tpipe
    box = tmp_path / "box"
    box.mkdir()
    (box / "bv.txt").write_text("-1 -1 -1\n1 1 1\n")
    t = cli._apply_bounding_volume(tpipe.load_scene(root), 0, str(box))
    j = jcli._apply_bounding_volume(jpipe.load_scene(root), 0, str(box))
    np.testing.assert_allclose([t.depth_min, t.depth_max],
                               [j.depth_min, j.depth_max], rtol=1e-12)


def _camera_sources(small, root, tmp_path, source):
    """load_scene keyword arguments for one camera source: the cams/
    files, Strecha P files (half of them named <name>.png.P) with the
    images folder and the depth range given, or a two-view KITTI calib
    file over a two-image folder."""
    def rows(P):
        return " ".join(f"{v:.17g}" for v in P.reshape(-1))
    if source == "cams":
        return {}
    if source == "p_folder":
        pdir = tmp_path / "P"
        pdir.mkdir()
        for i in range(small.num_views):
            suffix = ".P" if i % 2 else ".png.P"
            (pdir / f"{i:08d}{suffix}").write_text(
                "\n".join(" ".join(f"{v:.17g}" for v in r)
                          for r in small.P[i]) + "\n")
        return dict(images_folder=root / "images", p_folder=pdir,
                    depth_min=1.5, depth_max=7.5)
    two = tmp_path / "two"
    (two / "images").mkdir(parents=True)
    for i in range(2):
        name = f"{i:08d}.png"
        (two / "images" / name).write_bytes(
            (root / "images" / name).read_bytes())
    calib = tmp_path / "calib.txt"
    calib.write_text(f"P0: {rows(small.P[0])}\nP1: {rows(small.P[1])}\n")
    return dict(images_folder=two / "images", calib_file=calib)


@pytest.mark.parametrize("source", ["cams", "p_folder", "calib_file"])
def test_load_scene_camera_sources_match_jax(small, root, tmp_path, source):
    """The port's load_scene against the JAX package's for each camera
    source and its precedence: names, images, P and the depth range
    exactly (both read the same files with the same parsers)."""
    from tsar_mvs_tpu import pipeline as jpipe
    from tsar_mvs_tpu_torch import pipeline as tpipe
    kw = _camera_sources(small, root, tmp_path, source)
    t = tpipe.load_scene(root, **kw)
    j = jpipe.load_scene(root, **kw)
    assert t.names == j.names and len(t.names) == (2 if source ==
                                                   "calib_file" else 3)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.P, j.P)
    assert (t.depth_min, t.depth_max) == (j.depth_min, j.depth_max)
    assert t.images_dir == j.images_dir
    if source == "p_folder":
        assert (t.depth_min, t.depth_max) == (1.5, 7.5)
    if source == "calib_file":
        assert (t.depth_min, t.depth_max) == (-1.0, -1.0)
        with pytest.raises(ValueError):
            tpipe.load_scene(root, calib_file=kw["calib_file"])


def test_fuse_with_fuse_scene_flags(small, root):
    """scripts/fuse_scene.sh's flags on GT depth maps."""
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.models import fusion
    write_gt_results(small, root)
    assert cli.main(["fuse", str(root), "--depth_diff=0.01", "--angle=15",
                     "--num_consistent=1", "--reproj_error=2",
                     "--used_list=1"] + CPU) == 0
    pts = ply.read_ply(root / "results" / "TSAR_fused.ply")[0]
    ref = fusion.fuse(small.depth.astype(np.float32),
                      small.normal_world.astype(np.float32),
                      geo.build_camera_set(list(small.P), rebase=False,
                                           device="cpu"),
                      small.images, FusionParams())
    assert pts.shape[0] == ref.points.shape[0] > 0.5 * 48 * 64


def test_synth_then_scene_fuse(tmp_path):
    root = tmp_path / "synth"
    assert cli.main(["synth", str(root), "--height", "48", "--width", "64",
                     "--views", "3", "--seed", "3"]) == 0
    assert cli.main(["scene", str(root), "--fuse", "--iterations", "1",
                     "--no-ply"] + CPU) == 0
    for v in range(3):
        assert (root / "results" / f"{v:08d}" / "TSAR_disp.dmb").exists()
    pts = ply.read_ply(root / "results" / "TSAR_fused.ply")[0]
    assert pts.shape[0] > 0 and np.isfinite(pts).all()


def test_eval_depth_and_fscore(small, root, capsys):
    write_gt_results(small, root)
    d0 = root / "results" / "00000000"
    assert cli.main(["eval", str(d0 / "TSAR_disp.dmb"),
                     str(d0 / "TSAR_disp.dmb"), "--gtDepth_tolerance=0.1",
                     "--est_normal", str(d0 / "TSAR_normals.dmb"),
                     "--gt_normal", str(d0 / "TSAR_normals.dmb")]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["error"] == 0.0 and res["num_valid"] == res["num_gt"] > 0
    assert res["normal_mean_deg"] < 0.1
    cloud = root.parent / "cloud.ply"
    ply.write_ply(cloud, small.depth[0].reshape(-1, 1).repeat(3, 1),
                  np.zeros((48 * 64, 3)), np.zeros(48 * 64, np.uint8))
    assert cli.main(["eval", str(cloud), str(cloud), "--fscore"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["f1"] == 1.0


def test_view_vis_writes_pngs(root):
    assert cli.main(["view", str(root), "0", "--vis", "--iterations", "1"]
                    + CPU) == 0
    out = root / "results" / "00000000"
    for name in ("TSAR_normals.png", "TSAR_disp.png", "TSAR_confidence.png",
                 "TSAR_params.txt", "TSAR_disp.dmb"):
        assert (out / name).exists(), name


@pytest.mark.parametrize("cmd", ["view", "scene", "fuse", "gipuma"])
def test_no_silent_cpu_fallback(root, cmd, monkeypatch, capsys):
    """Without CUDA and without --device, the computing commands exit
    non-zero, name the flag, and write nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"view": ["view", str(root), "0"],
            "scene": ["scene", str(root), "--fuse"],
            "fuse": ["fuse", str(root)],
            "gipuma": ["gipuma", "00000000.png", "-mslp_folder",
                       str(root)]}[cmd]
    assert cli.main(argv) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (root / "results").exists()
