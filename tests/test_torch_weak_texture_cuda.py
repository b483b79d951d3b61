"""Kernel B7 (csrc/weak_texture.cu, wrapper ops/cuda_weak_texture.py)
against the plain weak-texture detection on the card, every field of
``WeakTexture`` equal to the bit (floats on their int64 views): the
stress inputs of ``kernel_times.B7_CASES`` (dashed strokes that split
regions, odd sides, one and no pyramid level, a constant image, noise
with no region over the floor, the 2K and dino sizes), tests/conftest's
96x128 scene with the pipeline tests' small detector thresholds and with
the defaults at one and two pyramid levels, and the benchmark's 2K and
dino views; then the counters and the host synchronisations of a call.

Every test is ``cuda``-marked and skips without a card. This file imports
nothing of JAX, so on the card:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m cuda \\
        tests/test_torch_weak_texture_cuda.py -q
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch import trace
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models import weak_texture as wt
from tsar_mvs_tpu_torch.ops import cuda_weak_texture as b7

ROOT = Path(__file__).resolve().parents[1]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _equal(gray, kw: dict, levels: int, name: str) -> None:
    row = kt.check_b7(gray, AlgorithmParams(**kw), levels, _card(), name)
    assert kt.b7_ok(row), row


@pytest.mark.cuda
@pytest.mark.parametrize("name", kt.B7_CASES)
def test_b7_equals_plain_on_the_stress_inputs(name):
    _equal(*kt.b7_case(name), name)


@pytest.fixture(scope="module")
def small_scene():
    from tsar_mvs_tpu_torch.utils.synthetic import make_scene
    return make_scene(height=96, width=128, num_views=5, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("view", [0, 1])
@pytest.mark.parametrize("kw", [kt.B7_SMALL, {}], ids=["small", "default"])
@pytest.mark.parametrize("levels", [1, 2])
def test_b7_equals_plain_on_the_small_scene(small_scene, view, kw, levels):
    _card()
    _equal(small_scene.images[view], kw, levels, f"scene view {view}")


def _benchmark_views(config_name: str):
    from benchmark import scene as bench_scene
    config = json.loads((ROOT / "benchmark" / "configs" /
                         f"{config_name}.json").read_text())
    W, H = config["resolution"]
    geo = config["scene"]
    sd = bench_scene.make_scene(
        H, W, config["images"], geo["texture_seed"], _card(),
        weak_fraction=geo["weak_fraction"], arc_radius=geo["arc_radius"],
        arc_span_deg=geo["arc_span_deg"], pair_top_k=config["pair_top_k"])
    return sd.images.cpu().numpy(), config["algorithm"]


@pytest.mark.cuda
@pytest.mark.parametrize("config_name", ["eth3d-2k", "middlebury-dino"])
def test_b7_equals_plain_on_the_benchmark_views(config_name):
    images, kw = _benchmark_views(config_name)
    for view in range(min(8, len(images))):
        _equal(images[view], kw, 2, f"{config_name} view {view}")


@pytest.mark.cuda
def test_counters_and_host_syncs_of_a_call():
    """The card's call launches B7's plan, never the plain version, draws
    the plain version's segments and waits for the card twice: the
    scalars and the readback (the upload does not wait)."""
    dev = _card()
    gray, kw, levels = kt.b7_case("dashed_odd")
    params = AlgorithmParams(**kw)
    trace.clear("weak_texture.segments")
    wt.detect_weak_texture(gray, params, levels)
    plain_segments = trace.counter("weak_texture.segments")
    wt.detect_weak_texture(gray, params, levels, device=dev)   # constants
    trace.reset()
    trace.on()
    try:
        with trace.span("call"):
            wt.detect_weak_texture(gray, params, levels, device=dev)
    finally:
        trace.off()
    plan = b7.plan(*gray.shape, levels, params.weak_text_num)
    assert trace.counter("launches.b7") == len(plan.kernels)
    assert trace.counter("weak_texture.plain_calls") == 0
    assert trace.counter("weak_texture.segments") == plain_segments > 0
    assert trace.counter("host_syncs") == 2
    trace.reset()


@pytest.mark.cuda
def test_results_own_their_memory():
    """Two calls' arrays do not share a buffer: the second call leaves the
    first one's labels as they were."""
    dev = _card()
    a_gray, kw, levels = kt.b7_case("dashed_0")
    b_gray, _, _ = kt.b7_case("dashed_1")
    params = AlgorithmParams(**kw)
    first = wt.detect_weak_texture(a_gray, params, levels, device=dev)
    kept = first.labels_full.copy()
    wt.detect_weak_texture(b_gray, params, levels, device=dev)
    assert (first.labels_full == kept).all()
