"""The port's tracer (``tsar_mvs_tpu_torch/trace.py``): spans inside
``process_view`` under its stage marks, the counters' registry, the B5 work
record, and, on the card, the clock and the host synchronisations.

CPU tests on a 96x128x5 scene of the port's own renderer; the
``cuda``-marked cases skip without a card (this file imports nothing of
JAX, so they run on the card with ``python -m pytest --noconftest -o
addopts= -m cuda tests/test_torch_trace.py``).
"""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import b5 as frozen_b5
from tsar_mvs_tpu_torch import kernel_times as kt
from tsar_mvs_tpu_torch import pipeline, trace
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.utils.synthetic import make_scene

STAGES = ("setup", "weak_texture", "slic", "patchmatch", "confidence",
          "wmf_mark", "ransac", "fill", "wmf_final", "finalize", "artifacts")
# tests/test_torch_pipeline.py's small-scene parameters, one PatchMatch
# iteration.
PARAMS = dict(iterations=1, weak_text_num=25, hough_thr=12,
              min_line_length=12, max_line_gap=3, ransac_iters=2000,
              ransac_anneal_rounds=200, ransac_thr_base=0.005,
              ransac_thr_max=0.05, ransac_thr_step=0.002, wmf_drift_thr=2.0,
              wmf_iters=2, wmf_final_iters=3)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """View 0 with tracing off, then views 1 and 2 with it on (their RANSAC
    inputs recorded): the timer's calls, the spans and the inputs."""
    root = tmp_path_factory.mktemp("trace_scene")
    make_scene(96, 128, 5, seed=0).export(root)
    scene = pipeline.load_scene(root)
    params = AlgorithmParams(**PARAMS)
    torch.set_num_threads(2)
    out = {"off": [], "on": []}
    trace.off()
    trace.reset()
    try:
        pipeline.process_view(scene, 0, params, device="cpu",
                              timer=out["off"].append, out_dir=root / "r0")
        out["spans_off"] = trace.collect()["spans"]
        trace.on()
        calls: list = []
        with kt.recording_ransac_inputs(calls):
            for ref in (1, 2):
                pipeline.process_view(scene, ref, params, device="cpu",
                                      timer=out["on"].append,
                                      out_dir=root / f"r{ref}")
        trace.off()
        out["collected"] = trace.collect()
        out["ransac_inputs"] = calls
    finally:
        trace.off()
        trace.reset()
    return out


def test_off_records_nothing_and_marks_the_stages(views):
    assert views["spans_off"] == []
    assert tuple(views["off"]) == STAGES
    assert tuple(views["on"]) == STAGES * 2


def test_every_span_nests_in_its_parent(views):
    spans = views["collected"]["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["view", "view"]
    assert [s["attrs"] for s in roots] == [{"view": 1}, {"view": 2}]
    children: dict = {}
    for s in spans:
        if s["parent"] is None:
            continue
        parent = by_id[s["parent"]]
        assert s["view"] == (parent["id"] if parent["name"] == "view"
                             else parent["view"])
        assert parent["start_us"] <= s["start_us"] <= s["end_us"] \
            <= parent["end_us"]
        children.setdefault(parent["id"], []).append(s["seconds"])
    for pid, secs in children.items():
        assert sum(secs) <= by_id[pid]["seconds"] + 1e-9
        assert by_id[pid]["self_s"] >= -1e-9
    for root in roots:
        stages = [s["name"] for s in spans if s["parent"] == root["id"]]
        assert tuple(stages) == STAGES


@pytest.mark.parametrize("child,stage", [
    ("fill.border_check", "fill"), ("patchmatch.inputs", "patchmatch"),
    ("patchmatch.pyramid", "patchmatch"), ("ransac.fit", "ransac"),
    ("ransac.polish", "ransac"), ("ransac.regions", "ransac"),
    ("weak_texture.hough", "weak_texture"), ("slic.graph", "slic"),
    ("finalize.readback", "finalize"), ("artifacts.maps", "artifacts")])
def test_parts_lie_inside_their_stage(views, child, stage):
    spans = views["collected"]["spans"]
    by_id = {s["id"]: s for s in spans}
    found = [s for s in spans if s["name"] == child]
    assert len(found) == 2
    for s in found:
        assert by_id[s["parent"]]["name"] == stage
        assert s["seconds"] <= by_id[s["parent"]]["seconds"]


def test_b5_work_record_is_the_packed_input(views):
    fits = [s["attrs"] for s in views["collected"]["spans"]
            if s["name"] == "ransac.fit"]
    inputs = views["ransac_inputs"]
    assert len(fits) == len(inputs) == 2
    for attrs, inp in zip(fits, inputs):
        assert attrs == {"regions": inp.offsets.shape[0] - 1,
                         "points": inp.points.shape[0],
                         "rounds": inp.idx.shape[1],
                         "anneal_rounds": inp.deltas.shape[1]}
        assert attrs["regions"] >= 1 and attrs["points"] >= 3


def test_frozen_b5_bound_summed_call_by_call_is_the_programs():
    packs = [[50000, 50000], [3, 17, 2048, 12289], [100]]
    rounds, anneal = 10, 1000
    calls, program_ms = [], 0.0
    for n in packs:
        want = kt.b5_bound(n, rounds, anneal)
        call = {"regions": len(n), "points": sum(n), "rounds": rounds,
                "anneal_rounds": anneal}
        assert frozen_b5.b5_counts(len(n), sum(n), rounds, anneal) == (
            want["bytes"], want["flops"])
        assert frozen_b5.b5_least_seconds([call]) * 1e3 == pytest.approx(
            want["bound_ms"], rel=1e-12)
        calls.append(call)
        program_ms += want["bound_ms"]
    assert frozen_b5.b5_least_seconds(calls) * 1e3 == pytest.approx(
        program_ms, rel=1e-12)


def test_off_span_is_the_shared_noop(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    trace.off()
    trace.reset()
    assert trace.span("x") is trace.NOOP
    assert trace.span("x", regions=3) is trace.NOOP
    assert trace.stage("x") is trace.NOOP
    with trace.span("x"), trace.stage("y"):
        pass
    assert trace.collect() == {"spans": [], "counters": {}}
    assert not trace.enabled()


def test_stage_calls_its_timer_on_success_only():
    names = []
    for on in (False, True):
        (trace.on if on else trace.off)()
        try:
            with trace.stage("a", names.append):
                pass
            with pytest.raises(ValueError):
                with trace.stage("b", names.append):
                    raise ValueError
        finally:
            trace.off()
    trace.reset()
    assert names == ["a", "a"]


def test_spans_record_while_the_profiler_records():
    from torch.profiler import ProfilerActivity, profile
    trace.off()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        with trace.span("profiled", k=1):
            pass
    with trace.span("after"):
        pass
    got = trace.collect()["spans"]
    trace.reset()
    assert [(s["name"], s["attrs"]) for s in got] == [("profiled",
                                                       {"k": 1})]


def test_counters_by_name_and_by_key():
    trace.reset()
    trace.count("launches.b5")
    trace.count("launches.b5")
    trace.count("launches_by_shape.b5", (2, 50000))
    trace.count("launches_by_shape.b5", (2, 50000))
    trace.count("launches_by_shape.b5", (1, 3))
    assert trace.counter("launches.b5") == 2
    assert trace.counter("launches.b1") == 0
    assert trace.by_key("launches_by_shape.b5") == {(2, 50000): 2, (1, 3): 1}
    assert trace.collect()["counters"] == {"launches.b5": 2}
    trace.clear("launches_by_shape.b5")
    assert trace.by_key("launches_by_shape.b5") == {}
    assert trace.counter("launches.b5") == 2
    trace.reset()
    assert trace.counter("launches.b5") == 0


def test_no_module_counter_outside_the_registry():
    """The counters that lived in module globals are gone."""
    from tsar_mvs_tpu_torch.models import tsar
    from tsar_mvs_tpu_torch.ops import (cuda_direct, cuda_halfpass,
                                        cuda_ncc, cuda_ransac, cuda_warp,
                                        cuda_wmf, halfpass)
    for mod in (cuda_direct, cuda_halfpass, cuda_ncc, cuda_ransac,
                cuda_warp, cuda_wmf):
        assert not any(n.startswith("LAUNCHES") for n in vars(mod))
    assert not hasattr(halfpass, "PLAIN_CALLS")
    assert not hasattr(tsar, "VIEWS_WITHOUT_REGIONS")


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_span_holds_a_kernel_on_the_profilers_clock():
    """A span around a spinning kernel (torch.cuda._sleep, then a
    synchronise) holds that kernel's profiler interval to within 50 us:
    the span's host instants and the profiler's device timestamps share
    one clock. Prints the offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with trace.span("spin"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
    spans = [s for s in trace.collect()["spans"] if s["name"] == "spin"]
    trace.reset()
    kernels = sorted(
        (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 2e5)
    assert len(spans) == len(kernels) == 5
    for s, (k0, k1) in zip(spans, kernels):
        print(f"kernel starts {k0 - s['start_us']:.1f} us after the span, "
              f"ends {s['end_us'] - k1:.1f} us before its end")
        assert k0 >= s["start_us"] - 50 and k1 <= s["end_us"] + 50


def _routes():
    import numpy as np
    dev = torch.device("cuda")
    y = torch.arange(1, 101, device=dev, dtype=torch.float32)
    ev = torch.cuda.Event()
    ev.record()
    return {"cpu": lambda: y.cpu(), "item": lambda: y.sum().item(),
            "tolist": lambda: y[:3].tolist(),
            "bool": lambda: bool(y[0] > 0), "float": lambda: float(y[0]),
            "nonzero": lambda: torch.nonzero(y),
            "masked_index": lambda: y[y > 50],
            "pageable_upload": lambda: torch.as_tensor(
                np.ones(8, np.float32), device=dev),
            "synchronize": lambda: torch.cuda.synchronize(),
            "stream_synchronize":
                lambda: torch.cuda.current_stream().synchronize(),
            "event_synchronize": lambda: ev.synchronize(),
            "none": lambda: y + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(
    ["cpu", "item", "tolist", "bool", "float", "nonzero", "masked_index",
     "pageable_upload", "synchronize", "stream_synchronize",
     "event_synchronize", "none"]))
def test_each_sync_route_counted_once(route):
    """Inside a span every route by which the host waits for the card adds
    one to host_syncs and to the span's syncs; an asynchronous op adds
    none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn = _routes()[route]
    torch.cuda.synchronize()
    trace.reset()
    trace.on()
    try:
        with trace.span("outer"):
            with trace.span("route"):
                fn()
    finally:
        trace.off()
    got = trace.collect()
    trace.reset()
    want = 0 if route == "none" else 1
    assert got["counters"].get("host_syncs", 0) == want
    assert [s["syncs"] for s in got["spans"]] == [0, want]
    assert torch.cuda.get_sync_debug_mode() == 0
