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
from benchmark.counts import b3 as frozen_b3
from benchmark.counts import kernels as counts
from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch import pipeline
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.models import patchmatch
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
        pair_top_k=cfg["pair_top_k"], color=geo.get("color", False))
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
    counts_ = pipeline.scene_plane_counts(scene, params, levels,
                                          frozen["sources"])
    if "planes" in frozen:
        assert [list(c) for c in counts_] == frozen["planes"]
    else:  # the direct sampler: no s-volume, so no plane counts
        assert counts_ == [None] * len(levels)
        assert patchmatch.resolve_ncc_impl(params) == "direct"
    if "channels" in frozen:
        assert frozen["channels"] == (3 if params.color_processing else 1)
        assert frozen["n_best"] == params.n_best
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
    if "planes" in frozen:
        assert counts.b2_least_seconds(frozen, cfg["resolution"])[1] == \
            sum(p["builds"] for p in plan)
    if "channels" in frozen:
        assert frozen_b3.b3_least_seconds(frozen, cfg["resolution"])[1] \
            == len(kt.launch_sequence(plan))


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


def _b3_bound(monkeypatch, H, W, C, CH, parity, V=7):
    """kernel_times' B3 bound of one evaluation of C candidates on an H x
    W level (the packed half grid at a parity, else the dense grid)
    against V views in CH channels, its source reads left out."""
    from types import SimpleNamespace
    monkeypatch.setattr(kt, "source_bytes_touched", lambda *a: 0)
    lv = {"params": AlgorithmParams()}
    views = SimpleNamespace(packed=[None] * V, channels=CH)
    s0 = torch.zeros((C, H, W if parity is None else W // 2))
    return kt.b3_bound(lv, views, s0, s0, s0, parity)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("CH", [1, 3])
def test_b3_counts(monkeypatch, H, W, C, CH):
    """B3 at a packed grid: kernel_times' operations, and its bytes with
    the source reads left out (the frozen count's lower bound)."""
    b = _b3_bound(monkeypatch, H, W, C, CH, 0)
    O = len(ncc.window_offsets(AlgorithmParams()))
    px = H * (W // 2)
    assert frozen_b3.b3_counts(px, C, O, 7, CH) == (b["bytes"], b["flops"])
    assert frozen_b3.b3_flops(px, O, 7, C, CH) == kt.b3_flops(px, O, 7, C,
                                                              CH)


def test_b3_least_seconds_at_one_levels_shapes(monkeypatch):
    """One level of the colour plan (1344x2048: 3 iterations, 4 banks, 4
    refine scales, its 10 sources): the frozen least seconds are
    kernel_times' bound summed over the level's launches, each shape's
    bound_ms times its launches."""
    plan = dict(CONFIGS["eth3d-2k-color3"]["plan"], levels=[1],
                iterations=[3], banks=[4], refine_scales=[4], init=[1])
    least, n = frozen_b3.b3_least_seconds(plan, [2048, 1344])
    halves = 2 * 3
    shapes = [(None, 1, 1), (0, 4, halves), (0, 1, halves * 4)]
    want = sum(k * _b3_bound(monkeypatch, 1344, 2048, C, 3, par,
                             V=plan["sources"])["bound_ms"]
               for par, C, k in shapes) / 1e3
    assert n == 1 + halves * 5
    assert least == pytest.approx(want, rel=1e-12)


def _b3_trace(config: str, kernels: dict, views: int) -> dict:
    return {"views": views, "kernels": kernels, "config": CONFIGS[config]}


B3_NAME = ("void (anonymous namespace)::direct_multiview_kernel<{}, {}, {}, "
           "true>((anonymous namespace)::Args, (anonymous namespace)::Views)")


def test_b3_reader_reads_the_plans_instance_only():
    """157 launches a view of the colour plan's instances (CH 3, NB 4 for
    n_best 3 over 10 views) give a share; the same launches of a gray or
    an n_best 1 instance, or too few, give nothing, as does a plan of
    the s-volume path."""
    reader = metrics.load("b3_roofline_pct")
    views = 3
    least, n = frozen_b3.b3_least_seconds(
        CONFIGS["eth3d-2k-color3"]["plan"],
        CONFIGS["eth3d-2k-color3"]["resolution"])
    assert n == 157
    assert frozen_b3.instance(CONFIGS["eth3d-2k-color3"]["plan"]) == (3, 4)
    secs = 4 * least * views

    def split(ch, nb):
        return {B3_NAME.format(8, ch, nb): [secs / 4, views],
                B3_NAME.format(4, ch, nb): [secs / 4, 60 * views],
                B3_NAME.format(1, ch, nb): [secs / 2, 96 * views],
                "halfpass_prop_select_kernel": [1.0, 10]}
    got = reader.read(_b3_trace("eth3d-2k-color3", split(3, 4), views))
    assert got == pytest.approx(25.0)
    for ch, nb in ((1, 4), (3, 1), (1, 1)):
        assert reader.read(_b3_trace("eth3d-2k-color3", split(ch, nb),
                                     views)) is None
    short = split(3, 4)
    short[B3_NAME.format(8, 3, 4)][1] -= 1
    assert reader.read(_b3_trace("eth3d-2k-color3", short, views)) is None
    assert reader.read(_b3_trace("eth3d-2k", split(3, 4), views)) is None


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
