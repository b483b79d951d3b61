"""The frozen kernel counts against the program's kernel_times, and every
per-layer reader against a recorded trace.

CPU only. The configurations' frozen plans (levels, iterations, banks,
refine scales, sources, window offsets, the scene-shared plane counts,
the WMF passes' offsets) are held to what the program derives for the
benchmark's scene (`kernel_times.launch_plan`,
`pipeline.scene_plane_counts`), and the count functions to
`kernel_times`' arithmetic at the main path's shapes and at 640x480.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import metrics
from benchmark import scene as bench_scene
from benchmark.counts import kernels as counts
from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch import pipeline
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.ops import ncc, wmf
from tsar_mvs_tpu_torch.utils import scene_io

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in SPEC["configs"]}
SHAPES = [(1344, 2048), (672, 1024), (336, 512), (480, 640), (240, 320)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frozen_plan_is_the_programs(monkeypatch, name):
    """The plan follows from the cameras, the depth range and the image
    size alone, so the scene renders untextured (32 textured 2K views
    take minutes on the CPU)."""
    monkeypatch.setattr(bench_scene, "value_noise",
                        lambda X, *a, **k: torch.zeros(
                            X.shape[:-1], dtype=X.dtype, device=X.device))
    cfg = CONFIGS[name]
    W, H = cfg["resolution"]
    geo = cfg["scene"]
    sd = bench_scene.make_scene(
        H, W, cfg["images"], 0, "cpu", weak_fraction=geo["weak_fraction"],
        arc_radius=geo["arc_radius"], arc_span_deg=geo["arc_span_deg"],
        pair_top_k=cfg["pair_top_k"])
    scene = pipeline.Scene(
        root=None, names=[f"{i:08d}" for i in range(cfg["images"])],
        images=sd.images.numpy(), P=sd.P, depth_min=sd.depth_min,
        depth_max=sd.depth_max, pair=scene_io.PairFile(neighbors=sd.pair))
    params = pipeline.default_params_for_scene(
        scene, AlgorithmParams(**cfg["algorithm"]))
    levels = pipeline.pyramid_levels_for(H)
    plan = kt.launch_plan(scene, params, levels)
    frozen = cfg["plan"]
    assert frozen["levels"] == [p["level"] for p in plan]
    assert frozen["iterations"] == [p["iterations"] for p in plan]
    assert frozen["banks"] == [p["banks"] for p in plan]
    assert frozen["refine_scales"] == [p["scales"] for p in plan]
    assert frozen["init"] == [p["init"] for p in plan]
    assert frozen["sources"] == plan[0]["builds"] == cfg["sources_per_view"]
    assert frozen["window_offsets"] == len(ncc.window_offsets(params))
    assert [list(c) for c in pipeline.scene_plane_counts(
        scene, params, levels, frozen["sources"])] == frozen["planes"]
    passes = ([wmf.pass_schedule("mark", i) for i in range(params.wmf_iters)]
              + [wmf.pass_schedule("fill", i)
                 for i in range(params.wmf_final_iters)])
    assert frozen["wmf_offsets"] == [len(wmf.sample_offsets(r, g))
                                     for r, g, _ in passes]
    # The launch counts the readers hold the trace to.
    assert counts.b1_least_seconds(frozen, cfg["resolution"])[1] == len(
        kt.launch_sequence(plan))
    assert counts.b6_least_seconds(frozen, cfg["resolution"])[1] == \
        kt.b6_launches(plan)
    assert counts.b2_least_seconds(frozen, cfg["resolution"])[1] == sum(
        p["builds"] for p in plan)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("C", [1, 4, 8])
def test_b1_counts(monkeypatch, H, W, C):
    """B1 at a packed grid: kernel_times' count with its volume reads left
    out (the frozen count's lower bound)."""
    monkeypatch.setattr(kt, "volume_bytes_touched", lambda *a: 0)
    params = AlgorithmParams()
    V = 7
    lv = {"params": params, "vol": type("V", (), {"data": [None] * V})()}
    s0 = torch.zeros((C, H, W // 2))
    b = kt.b1_bound(lv, s0, s0, s0, 0)
    O = len(ncc.window_offsets(params))
    assert counts.b1_counts(H * (W // 2), C, O, V) == (b["bytes"],
                                                       b["flops"])


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("S", [13, 217, 1024])
def test_b2_counts(H, W, S):
    assert counts.b2_counts(S, H, W) == (2 * S * H * W + 2 * H * W + 48,
                                         kt.B2_FLOPS_PER_VOXEL * S * H * W)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("O", [25, 121])
def test_b4_counts(H, W, O):
    b = kt.b4_bound(H, W, O)
    assert counts.least_seconds(counts.B4_BYTES_PER_PIXEL * H * W,
                                counts.b4_flops(H * W, O)) * 1e3 == \
        pytest.approx(b["bound_ms"], rel=1e-12)
    assert counts.b4_flops(H * W, O) == b["flops"]


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("kernel", sorted(counts.B6_FLOPS))
@pytest.mark.parametrize("banks", [4, 8])
def test_b6_counts(H, W, kernel, banks):
    b = kt.b6_bound(kernel, H, W, H, W // 2, banks, 0)
    assert counts.b6_counts(kernel, H, W, banks) == (b["bytes"], b["flops"])


SAMPLES = sorted((Path(__file__).parent / "data").glob("trace_*.json"))


@pytest.mark.parametrize("sample", SAMPLES, ids=lambda p: p.stem)
def test_every_reader_reads_a_recorded_trace(sample):
    """Every per-layer metric of BENCHMARK.json has its reader, and the
    reader gives a number on a trace recorded on the card in a cell the
    metric lists (shares of a roofline within (0, 100])."""
    rec = json.loads(sample.read_text())
    cell = {w["name"]: w for w in SPEC["workloads"]}[rec["workload"]]
    trace = dict(rec["trace"], config=CONFIGS[cell["config"]])
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        if rec["workload"] not in m.get("workloads", [rec["workload"]]):
            continue
        value = metrics.load(m["name"]).read(trace)
        assert value is not None, m["name"]
        if m["unit"] == "%":
            assert 0 < value <= 100, (m["name"], value)
