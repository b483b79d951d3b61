"""The benchmark's shape, its imports, and its refusal to run off the
card.

CPU tests, and one ``cuda``-marked test that runs a short cell on the
card (it skips here, deciding inside the test).
"""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_resolves_to_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        cfg = configs[w["config"]]
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith("benchmark/")
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    # At most a quarter of the cells (rounded down) on 4 chips, or one.
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                text = entry.get(key, "x")
                assert 1 <= len(text) <= 200 and "\n" not in text \
                    and "\t" not in text
    assert len(set(names)) == len(names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200


def test_result_line_keys_in_order():
    """A traced run's line (a small copy of a cell on the CPU) has the
    contract's keys in order, `check` last (main takes
    `forbidden_modules` out before it prints), and per-layer metrics."""
    import time
    from benchmark import run
    _, _, config = run.load_cell("middlebury-dino.images")
    config = dict(config, resolution=[128, 96], images=3,
                  sources_per_view=2,
                  algorithm={"iterations": 1, "wmf_iters": 1,
                             "wmf_final_iters": 1})
    limits = {k: {"limit": 1e9} for k in ("tex_bad2_mean", "tex_bad2_max",
                                          "tex_err_med", "tex_err_p25",
                                          "tex_nrm_med_deg", "views_missing")}
    res = run.run_cell("middlebury-dino.images", 7, 1.0, True, device="cpu",
                       config=config, limits=limits,
                       t_start=time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "forbidden_modules",
                         "measured", "check"]
    per_layer = {m["name"] for m in SPEC["per_layer"]}
    assert set(res["metrics"]) <= per_layer
    assert {"host_stages_s", "refine_s", "artifacts_s",
            "view_span_p95_s"} <= set(res["metrics"])
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        found = _imports(path) & {"tsar_mvs_tpu_torch", "tsar_mvs_tpu",
                                  "jax", "jaxlib", "flax"}
        assert not found, (path.name, found)


def test_nothing_of_jax_is_loaded_by_the_harness():
    """Import what a run imports (the harness, its readers, the reference
    and the port's modules it drives) in a fresh process; no top-level
    module named jax, jaxlib, flax or tsar_mvs_tpu may be loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run, scene, traffic, metrics, calibrate\n"
        "from benchmark import scene_job, scene_faults, scene_files\n"
        "from benchmark import calibrate_scene\n"
        "from benchmark.reference import check, cloud, control, truth\n"
        "from benchmark.counts import kernels\n"
        "import json\n"
        "for m in json.load(open(%r))['per_layer']:\n"
        "    metrics.load(m['name'])\n"
        "from tsar_mvs_tpu_torch import pipeline\n"
        "from tsar_mvs_tpu_torch.config import AlgorithmParams\n"
        "from tsar_mvs_tpu_torch.utils import scene_io\n"
        "print(run.forbidden_loaded())\n"
        % (str(ROOT), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "tsar_mvs_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert run.forbidden_loaded() == [m for m in ("jax", "tsar_mvs_tpu")
                                      if m in sys.modules]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_loaded()


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eth3d2k.images",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eth3d2k.images",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "middlebury-dino.images", "--seed", "4294967311", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["device"]["platform"] == "gpu"
