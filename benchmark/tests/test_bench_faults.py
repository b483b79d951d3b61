"""The harness, with the timed path broken underneath, finds the run not
correct.

CPU, in-process: `run.run_cell` skips the look for a card and drives the
rest of a run (scene, prior, warm-up, window, output check) on a small
copy of each traffic mix's cell: 96x128, 3 images, 2 sources; the images
mix with 2 iterations and 2 + 2 WMF passes, the APD mix with the default
4 + 6 (with 2 + 2 the refinement repairs too little of the prior at this
size for a fault that skips it to show) and textureless regions from 100
quarter-resolution pixels up (at the default 5,000 a 96x128 view has
none, and the fill has nothing to fill). The limits here are this size's
own, set from sound runs of it (images: tex_bad2_mean 0.048, _max 0.064,
median error 0.00097, best view's 25th percentile 0.00033, normals 3.5
degrees; APD: 0.020, 0.022, 0.0035, 0, weak_bad2_mean 0.012, where the
unrefined prior reads tex_bad2_mean 0.044 and the fill 5% long
weak_bad2_mean 0.18). Faults, each planted in the program (the planting
functions of ``benchmark/calibrate.py``, which reads them on the card):

- a step that returns its state unchanged: every PatchMatch step (the
  images mix, gray and colour), or the refinement (the APD mix: the
  written depth is the lifted prior's);
- half of the batch left out: `process_view` returns at once for every
  other reference view;
- an answer altered where it is produced: `finalize_stage` returns the
  depth 5% long, or the normals in the camera's frame; the fill writes its region planes 5% long (the APD mix:
  at this size only its views fit a region plane that the border check
  keeps); the colour cell's sources' channels rotated before the
  pyramid (``calibrate.color_sources_rotated``).

The colour cell's copy runs the direct sampler with n_best 3 on the
colour scene at the images mix's size, with the images mix's limits (its
sound runs read tex_bad2_mean 0.069-0.072, _max 0.079-0.085, median
error 0.0011-0.0015, best view's 25th percentile 0.00029-0.00034,
normals 4.6-7.0 degrees).

The exchange between chips does not exist in these one-card cells.
"""

import time

import pytest
import torch

from benchmark import calibrate, run
from tsar_mvs_tpu_torch import pipeline
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.models import tsar

SMALL = {"eth3d2k.images": {"resolution": [128, 96], "images": 3,
                            "sources_per_view": 2,
                            "algorithm": {"iterations": 2, "wmf_iters": 2,
                                          "wmf_final_iters": 2}},
         "eth3d2k.apd": {"resolution": [128, 96], "images": 3,
                         "sources_per_view": 2,
                         "algorithm": {"weak_text_num": 100}},
         "eth3d2k.color3": {"resolution": [128, 96], "images": 3,
                            "sources_per_view": 2,
                            "algorithm": {"color_processing": True,
                                          "n_best": 3, "iterations": 2,
                                          "wmf_iters": 2,
                                          "wmf_final_iters": 2}}}
LIMITS = {"eth3d2k.images": {"tex_bad2_mean": 0.2, "tex_bad2_max": 0.2,
                             "tex_err_med": 0.003, "tex_err_p25_min": 0.0012,
                             "tex_nrm_med_deg": 10.0, "views_missing": 0},
          "eth3d2k.apd": {"tex_bad2_mean": 0.03, "tex_bad2_max": 0.06,
                          "tex_err_med": 0.02, "tex_nrm_med_deg": 10.0,
                          "weak_bad2_mean": 0.06, "views_missing": 0},
          "eth3d2k.color3": {"tex_bad2_mean": 0.2, "tex_bad2_max": 0.2,
                             "tex_err_med": 0.003, "tex_err_p25_min": 0.0012,
                             "tex_nrm_med_deg": 10.0, "views_missing": 0}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads a test worker, so that parallel workers do
    not starve each other's windows of views."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_run(workload: str) -> dict:
    """One rotation of the small copy of `workload`, as many views as a
    run compares."""
    _, _, config = run.load_cell(workload)
    limits = {k: {"limit": v} for k, v in LIMITS[workload].items()}
    small = dict(config, **SMALL[workload])
    return run.run_cell(workload, 3000000017, 0.0, False, device="cpu",
                        config=small, limits=limits,
                        t_start=time.perf_counter(),
                        min_views=small["images"])


@pytest.mark.parametrize("workload", sorted(LIMITS))
def test_sound_run_is_correct(workload):
    res = small_run(workload)
    assert res["correct"], res["check"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "forbidden_modules", "measured", "check"]
    assert res["forbidden_modules"] == []


def test_patchmatch_step_unchanged(monkeypatch):
    monkeypatch.setattr(pm, "make_patchmatch_step",
                        lambda *a, **k: (lambda state, generator: state))
    res = small_run("eth3d2k.images")
    assert not res["correct"], res["check"]


def test_color_patchmatch_step_unchanged(monkeypatch):
    monkeypatch.setattr(pm, "make_patchmatch_step",
                        lambda *a, **k: (lambda state, generator: state))
    res = small_run("eth3d2k.color3")
    assert not res["correct"], res["check"]


def test_color_sources_rotated(monkeypatch):
    """The sources' channels rotated (R <- G <- B) before the pyramid: the
    colour cost matches each reference channel against another channel
    (tex_bad2_mean 0.26-0.28 and median error 0.008-0.010 on three seeds
    at this size, where sound runs read 0.069-0.072 and 0.0011-0.0015)."""
    monkeypatch.setattr(pm, "run_patchmatch_pyramid",
                        calibrate.color_sources_rotated(
                            pm.run_patchmatch_pyramid))
    res = small_run("eth3d2k.color3")
    assert not res["correct"], res["check"]
    assert res["check"]["tex_bad2_mean"]["value"] > 0.2


def test_refinement_unchanged(monkeypatch):
    monkeypatch.setattr(tsar, "tsar_refine",
                        calibrate.refine_unchanged(tsar.tsar_refine))
    res = small_run("eth3d2k.apd")
    assert not res["correct"], res["check"]


def test_fill_written_long(monkeypatch):
    monkeypatch.setattr(tsar, "fill_stage",
                        calibrate.fill_offset(tsar.fill_stage))
    res = small_run("eth3d2k.apd")
    assert not res["correct"], res["check"]
    assert res["check"]["weak_bad2_mean"]["value"] > 0.06


@pytest.mark.parametrize("workload", sorted(LIMITS))
def test_half_the_views_left_out(monkeypatch, workload):
    real = pipeline.process_view

    def half(scene, ref, *a, **k):
        if ref % 2:
            return None
        return real(scene, ref, *a, **k)
    monkeypatch.setattr(pipeline, "process_view", half)
    res = small_run(workload)
    assert not res["correct"], res["check"]
    assert res["check"]["views_missing"]["value"] > 0


@pytest.mark.parametrize("fault", ["depth_long", "normals_camera"])
@pytest.mark.parametrize("workload", sorted(LIMITS))
def test_depth_altered_where_produced(monkeypatch, workload, fault):
    _, target, plant = calibrate.FAULTS[fault]
    monkeypatch.setattr(tsar, target, plant(getattr(tsar, target)))
    res = small_run(workload)
    assert not res["correct"], res["check"]
