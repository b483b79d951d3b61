"""The readers of the program's own spans and counters
(``benchmark/spans.py``, ``metrics/{b5_roofline_pct, border_check_s,
inputs_s, host_syncs_per_view}.py``) and the idle-by-span attribution, on
synthetic traces; and a traced run on the CPU whose readers read the
program's live tracer.

CPU only.
"""

import json
import sys
from pathlib import Path

import pytest

from benchmark import metrics, spans
from benchmark.counts import b5 as frozen_b5

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("b5_roofline_pct", "border_check_s", "inputs_s",
       "host_syncs_per_view")
CALLS = [{"regions": 2, "points": 100000, "rounds": 10,
          "anneal_rounds": 1000}] * 4


def _trace(**program):
    tr = {"views": 4, "window_s": 5.0, "busy_s": 1.0, "spans": {},
          "kernels": {"ransac_count_kernel": [0.004, 40],
                      "ransac_decide_kernel": [0.002, 40],
                      "ransac_anneal_kernel": [0.010, 4]},
          "launches": 84}
    tr.update({"program_spans": {"fill.border_check": [0.4, 0.4],
                                 "patchmatch.inputs": [0.12, 0.12],
                                 "ransac.fit": [0.02, 0.02]},
               "program_counters": {"host_syncs": 1000},
               "b5_calls": CALLS})
    tr.update(program)
    return tr


def test_readers_read_the_program_summaries():
    tr = _trace()
    read = {name: metrics.load(name).read(tr) for name in NEW}
    assert read["border_check_s"] == pytest.approx(0.1)
    assert read["inputs_s"] == pytest.approx(0.03)
    assert read["host_syncs_per_view"] == pytest.approx(250)
    least = frozen_b5.b5_least_seconds(CALLS)
    assert read["b5_roofline_pct"] == pytest.approx(100 * least / 0.016)
    assert 0 < read["b5_roofline_pct"] <= 100


def test_readers_leave_out_what_the_program_did_not_record():
    tr = _trace(program_spans={}, program_counters={}, b5_calls=[])
    assert all(metrics.load(n).read(tr) is None for n in NEW)
    tr = _trace()
    tr["kernels"] = {}
    assert metrics.load("b5_roofline_pct").read(tr) is None


def test_readers_give_nothing_for_a_program_without_a_tracer(monkeypatch):
    """A parent checkout's program has no trace module: every new reader
    returns None and none raises."""
    tr = _trace()
    for key in ("program_spans", "program_counters", "b5_calls"):
        del tr[key]
    import tsar_mvs_tpu_torch
    monkeypatch.setitem(sys.modules, "tsar_mvs_tpu_torch.trace", None)
    monkeypatch.delattr(tsar_mvs_tpu_torch, "trace", raising=False)
    assert spans.program(tr) is None
    assert all(metrics.load(n).read(tr) is None for n in NEW)


def test_summary_of_collected_spans():
    got = {"spans": [
        {"name": "fill", "seconds": 1.0, "self_s": 0.6, "attrs": {}},
        {"name": "fill.border_check", "seconds": 0.4, "self_s": 0.4,
         "attrs": {}},
        {"name": "ransac.fit", "seconds": 0.1, "self_s": 0.1,
         "attrs": CALLS[0]},
        {"name": "fill", "seconds": 2.0, "self_s": 2.0, "attrs": {}}],
        "counters": {"host_syncs": 7}}
    s = spans.summary(got)
    assert s["program_spans"] == {"fill": [3.0, 2.6],
                                  "fill.border_check": [0.4, 0.4],
                                  "ransac.fit": [0.1, 0.1]}
    assert s["program_counters"] == {"host_syncs": 7}
    assert s["b5_calls"] == [CALLS[0]]


def _span(i, name, parent, a, b):
    return {"id": i, "name": name, "parent": parent, "start_us": a,
            "end_us": b}


def test_idle_by_span_takes_the_innermost_open_span():
    """Two views; the device runs [0, 10) and [40, 55) and [95, 100):
    idle 10-40 falls in fill.border_check (20-30) and else in fill; 55-95
    in artifacts (55-60), between the views (60-70) and in the second
    view's setup (70-95)."""
    sp = [_span(0, "view", None, 0, 60), _span(1, "fill", 0, 5, 50),
          _span(2, "fill.border_check", 1, 20, 30),
          _span(3, "artifacts", 0, 50, 60),
          _span(4, "view", None, 70, 100), _span(5, "setup", 4, 70, 100)]
    busy = [(0, 10), (40, 55), (95, 100), (-50, -40)]
    idle = spans.idle_by_span(busy, sp)
    assert idle == pytest.approx({"fill": 20e-6, "fill.border_check": 10e-6,
                                  "artifacts": 5e-6,
                                  "between_views": 10e-6,
                                  "setup": 25e-6})
    assert spans.idle_by_span(busy, []) == {}


def test_idle_gaps_merge_overlapping_operations():
    assert spans.idle_gaps([(2, 5), (3, 4), (4, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]


def test_new_metrics_are_declared_with_their_cells():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for name in NEW:
        assert per_layer[name]["moves"] == "views_per_s"
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()
    assert per_layer["b5_roofline_pct"]["workloads"] == [
        "eth3d2k.images", "eth3d2k.apd"]
    for name in NEW[1:]:
        assert per_layer[name]["workloads"] == cells


def test_traced_cpu_run_reads_the_live_tracer():
    """A traced run of a small copy of a cell on the CPU: the profiler
    turns the program's spans on, and the span and counter readers find
    them (no card: no host synchronisation, no B5 kernel)."""
    import time
    from benchmark import run
    from tsar_mvs_tpu_torch import trace
    trace.reset()
    _, _, config = run.load_cell("eth3d2k.images")
    config = dict(config, resolution=[128, 96], images=3,
                  sources_per_view=2,
                  algorithm={"iterations": 1, "wmf_iters": 1,
                             "wmf_final_iters": 1})
    limits = {k: {"limit": 1e9} for k in ("tex_bad2_mean", "views_missing")}
    try:
        res = run.run_cell("eth3d2k.images", 11, 1.0, True, device="cpu",
                           config=config, limits=limits,
                           t_start=time.perf_counter())
    finally:
        trace.reset()
    assert res["metrics"]["border_check_s"]["value"] > 0
    assert res["metrics"]["inputs_s"]["value"] > 0
    assert "host_syncs_per_view" not in res["metrics"]
    assert "b5_roofline_pct" not in res["metrics"]
