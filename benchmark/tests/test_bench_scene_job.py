"""The scene driver (``benchmark/scene_job.py``) and the fused cloud's
check (``benchmark/reference/cloud.py``), on the CPU.

The driver runs a small copy of ``eth3d2k.scene4`` on 2 gloo ranks that
share the CPU: 7 views of 96x64 (4 and 3 a rank, so the last rank's
slice is padded in the gather, as the cell's 10/10/10/8 is), 4 sources a
view, two PatchMatch iterations and one WMF pass each way, so that a job
takes about 10 s. Its limits are this size's own, set from sound runs of
it (job seeds of 11 and 12: tex_bad2_mean 0.138-0.139, cloud_acc_bad
0.017-0.018, cloud_comp_bad 0.239-0.245, cloud_bf16_grid 0-4e-5) and the
faults' readings (the depth 5% long: tex_bad2_mean 0.985; the points 5%
long: cloud_acc_bad 0.80-0.83; every second view's points dropped:
cloud_comp_bad 0.42-0.44; a cloud in bfloat16: cloud_bf16_grid 1).
Faults (``benchmark/scene_faults.py``), planted in the rank processes:

- an answer altered where it is produced: the depth 5% long; the fused
  points 5% long from their camera;
- half of the batch left out: every second view's points dropped from
  the cloud; fusion skipped;
- the exchange between chips left out: the last rank's maps never reach
  rank 0's fusion;
- a rank that raises: the run ends long before its deadline, with the
  job's views counted as failed.

The cloud's check alone runs on clouds fused from the truth.
"""

import os
import time

import numpy as np
import pytest
import torch

from benchmark import run, scene_faults, scene_job, scene_files, traffic
from benchmark import scene as bench_scene
from benchmark.reference import cloud
from benchmark.reference import truth as tr

WORKLOAD = "eth3d2k.scene4"
SMALL = {"resolution": [96, 64], "images": 7, "sources_per_view": 4,
         "pair_top_k": 4,
         "algorithm": {"iterations": 2, "wmf_iters": 1,
                       "wmf_final_iters": 1}}
DEADLINE_S = 300.0
LIMITS = {"tex_bad2_mean": 0.4, "views_missing": 0, "cloud_missing": 0,
          "cloud_acc_bad": 0.1, "cloud_comp_bad": 0.33,
          "cloud_bf16_grid": 0.005}


def small_config() -> dict:
    _, _, config = run.load_cell(WORKLOAD)
    return dict(config, **SMALL)


def limits() -> dict:
    return {k: {"limit": v} for k, v in LIMITS.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread_a_rank():
    """The rank processes inherit one intra-op thread, so that parallel
    test workers do not starve each other."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if before is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = before


def small_run(trace: bool = False, fault: str | None = None) -> dict:
    """One window job of the small copy."""
    return scene_job.run_cell(WORKLOAD, 3000000017, 0.0, trace,
                              device="cpu", config=small_config(),
                              limits=limits(), t_start=time.perf_counter(),
                              world=2, fault=fault, deadline_s=DEADLINE_S)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_line(trace):
    res = small_run(trace)
    assert res["correct"], res["check"]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[:len(keys)] == keys
    assert list(res)[-3:] == ["forbidden_modules", "measured", "check"]
    assert res["forbidden_modules"] == []
    # Views, not jobs: the one window job's 7 views.
    assert res["attempted"] == 7 and res["failed"] == 0
    assert res["device"]["count"] == 2
    assert set(res["check"]) == set(LIMITS)
    if trace:
        # No card: no device operation, so nothing is busy and no
        # host synchronisation or B5 launch is counted.
        assert {"scene_maps_s", "fusion_s", "device_idle_pct"} <= set(
            res["metrics"])
        assert res["metrics"]["device_idle_pct"]["value"] == 100
        assert not {"device_busy_s", "launches_per_view", "b5_roofline_pct",
                    "host_syncs_per_view"} & set(res["metrics"])
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert all(name.startswith(("rank0.", "rank1."))
                   for name, _ in res["breakdown"]["idle_gaps"])
    else:
        assert set(res["metrics"]) == {"views_per_s", "depth_acc2",
                                       "setup_s"}
        assert res["metrics"]["views_per_s"]["value"] > 0


@pytest.fixture(scope="module")
def session():
    s = scene_job.Session(small_config(), "cpu", 2, deadline_s=DEADLINE_S)
    yield s
    s.close()


def test_sound_job_and_fusion_faults(session):
    """A sound job passes; each fusion fault, fused again from the same
    maps, fails."""
    session.job(traffic.view_seed(11, 0))
    sound = session.check(limits())
    assert sound["correct"], sound["compared"]
    for name in scene_faults.FUSION:
        session.plant(name)
        try:
            session.fuse_again()
            got = session.check(limits())
        finally:
            session.unplant()
        assert not got["correct"], (name, got["compared"])
    session.fuse_again()
    assert session.check(limits())["correct"]


def test_depth_long_is_not_correct(session):
    session.plant("depth_long")
    try:
        session.job(traffic.view_seed(11, 0))
        got = session.check(limits())
    finally:
        session.unplant()
    assert not got["correct"], got["compared"]
    assert got["compared"]["tex_bad2_mean"]["value"] > 0.9


@pytest.mark.parametrize("fault", ["rank_raises", "maps_not_shared"])
def test_a_failing_rank_ends_the_run(fault):
    t0 = time.perf_counter()
    res = small_run(fault=fault)
    # The failing rank ends the run, not the job's deadline.
    assert time.perf_counter() - t0 < DEADLINE_S
    assert not res["correct"]
    # The untimed job fails: its views count as attempted and failed.
    assert res["attempted"] == res["failed"] == 7
    assert res["check"] == {"views_failed": {"value": 7, "limit": 0}}


def test_scene_files_load_as_written(tmp_path):
    """The benchmark's writers give the program the render's images,
    cameras (equal to the bit), depth range and pair ranking."""
    from tsar_mvs_tpu_torch import pipeline
    sd = bench_scene.make_scene(48, 64, 3, 0, "cpu", arc_span_deg=60.0,
                                pair_top_k=2)
    names = [f"{i:08d}" for i in range(3)]
    scene_files.write_scene(tmp_path, names, sd.images.numpy(), sd.K, sd.R,
                            sd.t, sd.depth_min, sd.depth_max, sd.pair)
    scene = pipeline.load_scene(tmp_path)
    assert scene.names == names
    assert np.array_equal(scene.images, sd.images.numpy())
    assert np.array_equal(scene.P, sd.P)
    assert (scene.depth_min, scene.depth_max) == (sd.depth_min,
                                                  sd.depth_max)
    assert scene.pair.neighbors == sd.pair


def test_ply_reader_reads_the_programs_ply(tmp_path):
    from tsar_mvs_tpu_torch.utils import ply
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    ply.write_ply(tmp_path / "a.ply", pts, pts, np.zeros(50, np.uint8))
    assert np.array_equal(cloud.read_ply_points(tmp_path / "a.ply"), pts)
    assert cloud.read_ply_points(tmp_path / "none.ply") is None


def test_surface_distance():
    rect = (np.zeros(3), np.array([2.0, 0.0, 0.0]), np.array([1.0, 1.0, 0.0]))
    pts = torch.tensor([[1.5, 0.5, 0.3],     # over the parallelogram
                        [-1.0, 0.0, 0.0],    # beyond the corner (0, 0, 0)
                        [1.0, -2.0, 4.0]],   # beyond the edge y = 0
                       dtype=torch.float64)
    d = cloud.surface_distance(pts, [rect])
    assert torch.allclose(d, torch.tensor([0.3, 1.0, 20 ** 0.5],
                                          dtype=torch.float64))


@pytest.fixture(scope="module")
def truth_cloud():
    """8 views of 48x64 and their truth maps fused by the program."""
    from tsar_mvs_tpu_torch import geometry as geo
    from tsar_mvs_tpu_torch.config import FusionParams
    from tsar_mvs_tpu_torch.models import fusion
    sd = bench_scene.make_scene(48, 64, 8, 0, "cpu", arc_span_deg=60.0,
                                pair_top_k=4)
    depth = torch.where(torch.isfinite(sd.depth), sd.depth, 0.0)
    normals = np.stack([tr.facing_normals(sd, v).float().numpy()
                        for v in range(8)])
    cams = geo.build_camera_set(list(sd.P), rebase=False, device="cpu")
    fused = fusion.fuse(depth.float().numpy(), normals, cams,
                        sd.images.numpy(), FusionParams())
    sources = {v: [j for j, _ in sd.pair[v]] for v in range(8)}
    rects = [(r.origin, r.eu, r.ev) for r in bench_scene.rectangles(0.25)]
    return sd, fused, cams, sources, rects


def _numbers(tmp_path, truth_cloud, points):
    from tsar_mvs_tpu_torch.utils import ply
    sd, _, _, sources, rects = truth_cloud
    ply.write_ply(tmp_path / "c.ply", points, points,
                  np.zeros(len(points), np.uint8))
    return cloud.measure(sd, rects, sources, tmp_path / "c.ply", "cpu")


def test_cloud_of_the_truth_and_its_faults(tmp_path, truth_cloud):
    sd, fused, cams, _, _ = truth_cloud
    sound = _numbers(tmp_path, truth_cloud, fused.points)
    assert sound["cloud_missing"] == 0
    # A few points at the foreground's edges average votes across it.
    assert sound["cloud_acc_bad"] < 0.01
    assert sound["cloud_comp_bad"] < 0.1
    C = cams.C.numpy()[fused.view_of]
    long = _numbers(tmp_path, truth_cloud, C + 1.05 * (fused.points - C))
    assert long["cloud_acc_bad"] > 0.5
    even = _numbers(tmp_path, truth_cloud,
                    fused.points[fused.view_of % 2 == 0])
    assert even["cloud_comp_bad"] > 3 * sound["cloud_comp_bad"]
    # float32 points lie on the bfloat16 grid 2^-16 of the time; a cloud
    # held in bfloat16 always does, and is as accurate as tau asks.
    assert sound["cloud_bf16_grid"] < 1e-3
    half = fused.points.astype(np.float32)
    half = torch.from_numpy(half).to(torch.bfloat16).float().numpy()
    bf16 = _numbers(tmp_path, truth_cloud, half)
    assert bf16["cloud_bf16_grid"] == 1
    assert bf16["cloud_acc_bad"] < 0.02
    none = cloud.measure(sd, truth_cloud[4], truth_cloud[3],
                         tmp_path / "absent.ply", "cpu")
    assert none["cloud_missing"] == 1


def test_control_cloud_fails_only_on_the_bfloat16_grid(truth_cloud):
    """The reference's cloud in bfloat16 lies (all but the farthest
    points, where bfloat16's spacing passes tau) within tau of the
    surfaces, and wholly on the bfloat16 grid."""
    sd, _, _, sources, rects = truth_cloud
    pts = cloud.control_cloud(sd, sources, "cpu")
    assert pts.dtype == np.float32 and pts.shape[1] == 3
    got = cloud.measure_points(sd, rects, sources, pts, "cpu")
    assert got["cloud_acc_bad"] < 0.01
    assert got["cloud_bf16_grid"] == 1
    assert got["cloud_bf16_grid"] > LIMITS["cloud_bf16_grid"]


def test_each_job_clears_the_last_jobs_results(session):
    """Rank 0 deletes the last job's results before a job and says how
    long that took, so that the check reads what the last job wrote and
    the run can take the deletion out of its window."""
    session.job(traffic.view_seed(12, 0))
    stale = session.work / "scene" / "results" / "stale"
    stale.write_text("left by an earlier job")
    job = session.job(traffic.view_seed(12, 1))
    assert job["clear_s"] > 0
    assert not stale.exists()
    assert session.check(limits())["correct"]
