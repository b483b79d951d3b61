"""The port's harnesses (`tsar_mvs_tpu_torch/bench.py`, `bench_patchmatch.py`,
`bench_scaling.py`), scene's spawning of one rank per card (C9) and SLIC's
connectivity suppression, on the CPU at small sizes.

Neither JAX harness runs here: their process_view-sized compiles cost
minutes. The JSON keys are read from the root `bench.py` and
`bench_scaling.py` sources; accuracy() is held to `bench.py`'s formulas
in numpy with the JAX package's `source_coverage` to 1e-12; SLIC's
suppression equals the JAX function exactly (integer labels). Summed
PatchMatch costs at 1 and 2 spawned gloo ranks are equal exactly (each
reference draws from fold_in(seed, level, view id)). The cases that need
a card are marked `cuda` and skip without one.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsar_mvs_tpu.ops import slic as jslic
from tsar_mvs_tpu.utils.synthetic import make_scene, source_coverage
from tsar_mvs_tpu_torch import _build, bench, bench_patchmatch, bench_scaling
from tsar_mvs_tpu_torch import cli, pipeline
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.models import tsar
from tsar_mvs_tpu_torch.ops import slic, wmf
from tsar_mvs_tpu_torch.parallel import distributed

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SMALL_ENV = {"TSAR_BENCH_SMALL": "1", "TSAR_BENCH_H": "48",
             "TSAR_BENCH_W": "64", "TSAR_BENCH_VIEWS": "3",
             "TSAR_BENCH_ITERS": "1"}
# bench.py's stage names, in its order (bench.py:129-198).
STAGES = ["weak_texture", "slic", "patchmatch", "confidence", "wmf_mark",
          "ransac", "fill", "wmf_final", "finalize"]


def dumped_keys(path: Path, func: str) -> list[str]:
    """The string keys of the dict literals that `func` in the file at
    `path` passes to json.dumps or assigns to `rec`, in source order."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    dicts = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            dicts.append(node.args[0])
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "rec"):
            dicts.append(node.value)
    dicts.sort(key=lambda d: (d.lineno, d.col_offset))
    return [k.value for d in dicts for k in d.keys
            if isinstance(k, ast.Constant)]


@pytest.fixture(scope="module")
def small():
    return make_scene(height=48, width=64, num_views=3, seed=0)


def set_env(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_bench_main_small_prints_bench_keys(monkeypatch, capsys):
    """`bench.main(["--device", "cpu"])` at 48x64x3, 1 iteration, exits 0
    and prints one JSON line with the root bench.py's keys, tpu_crosscheck
    renamed cuda_crosscheck and "skipped (cpu)", and bench.py's stages."""
    set_env(monkeypatch, **SMALL_ENV)
    for var in ("TSAR_BENCH_DIAG", "TSAR_BENCH_PROFILE", "TSAR_NCC_IMPL",
                "TSAR_BENCH_REPEATS"):
        monkeypatch.delenv(var, raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    jax_keys = dumped_keys(ROOT / "bench.py", "main")
    assert "tpu_crosscheck" in jax_keys
    assert list(res) == ["cuda_crosscheck" if k == "tpu_crosscheck" else k
                         for k in jax_keys]
    assert res["cuda_crosscheck"] == "skipped (cpu)"
    assert list(res["stages"]) == STAGES
    assert res["unit"] == "depthmaps/s @48x64x1it/2src (full pipeline)"
    baseline = 0.05 * (1344 * 2048 / (48 * 64)) * (7 / 2)
    assert res["vs_baseline"] == pytest.approx(res["value"] / baseline,
                                               abs=2e-3)
    assert 0.0 < res["acc2_pm"] <= 1.0 and 0.0 < res["matchable_frac"] <= 1.0


def test_bench_without_card_exits_1(monkeypatch, capsys):
    """Without a card and without --device cpu the bench exits 1 and names
    the flag, both by itself and through the CLI's `bench`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    set_env(monkeypatch, **SMALL_ENV)
    assert bench.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert cli.main(["bench"]) == 1
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err and captured.out == ""


def test_accuracy_matches_bench_formulas(small):
    """accuracy() on fixed depths (the ground truth with seeded noise, a
    seeded reliability mask) equals bench.py:236-266's formulas, computed
    here in numpy with the JAX package's source_coverage."""
    rng = np.random.default_rng(3)
    gt = small.depth[0]
    fill = np.float32(np.median(gt[np.isfinite(gt)]))

    def noisy():
        return np.where(np.isfinite(gt),
                        gt * (1.0 + 0.03 * rng.standard_normal(gt.shape)),
                        fill)

    cams = bench.cameras(small, "cpu")
    state = pm.state_from_prior(
        torch.as_tensor(noisy(), dtype=torch.float32),
        torch.as_tensor(small.normal_world[0]), cams)
    depth_final = noisy().astype(np.float32)
    reliable = rng.random(gt.shape) < 0.7
    view_ids = (1, 2)
    got = bench.accuracy(small, state, depth_final, reliable, view_ids)

    depth_pm = pm.depth_map(state, cams).numpy()
    ok = np.isfinite(gt) & ~small.weak_mask[0]
    matchable = ok & (source_coverage(small, ref=0, src_views=view_ids) >= 1)
    weak_sel = np.isfinite(gt) & small.weak_mask[0]

    def acc2(depth, sel):
        rel = np.abs(depth - gt) / np.where(np.isfinite(gt), gt, 1.0)
        return float((rel[sel] < 0.02).mean()) if sel.any() else 0.0

    want = {"acc2_pm": acc2(depth_pm, matchable),
            "acc2_final": acc2(depth_final, matchable),
            "acc2_reliable": acc2(depth_final, reliable & matchable),
            "acc2_pm_all_textured": acc2(depth_pm, ok),
            "acc2_weak_pm": acc2(depth_pm, weak_sel),
            "acc2_weak_final": acc2(depth_final, weak_sel),
            "matchable_frac": float(matchable[ok].mean())}
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert 0.05 < want["acc2_pm"] < 0.95 and weak_sel.any()


def test_stage_sequence(small, monkeypatch):
    """One small view runs bench.py's stages in its order, 2 WMF marking
    and 2 fill passes, and neither the border check nor tsar_refine."""
    calls = {"border_veto": 0, "tsar_refine": 0, "wmf_mark_outliers": 0,
             "wmf_fill": 0}

    def counted(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((tsar, "border_veto"), (tsar, "tsar_refine"),
                      (wmf, "wmf_mark_outliers"), (wmf, "wmf_fill")):
        counted(mod, name)
    params = bench.bench_params(small, 1, "auto", True)
    stages: dict = {}
    state, depth, n_world, reliable = bench.one_view(
        small, params, torch.Generator().manual_seed(1), stages)
    assert calls == {"border_veto": 0, "tsar_refine": 0,
                     "wmf_mark_outliers": 2, "wmf_fill": 2}
    assert list(stages) == STAGES
    assert depth.shape == (48, 64) and n_world.shape == (48, 64, 3)
    assert torch.isfinite(depth).all() and reliable.dtype == torch.bool
    full = bench.bench_params(small, 8, "pallas", False)
    assert (full.wmf_iters, full.wmf_final_iters, full.ncc_impl) == (
        4, 6, "svolume")


def test_bench_diag_prints_attribution(monkeypatch, capsys):
    """TSAR_BENCH_DIAG=1 prints the stage attribution of bench.py:48-78
    instead of the bench line."""
    set_env(monkeypatch, **SMALL_ENV, TSAR_BENCH_DIAG="1")
    assert bench.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = ["acc2_pm", "acc2_after_fill", "frac_matchable_marked_unreliable",
            "frac_good_marked_unreliable"]
    for it in range(2):
        want += [f"acc2_wmf_final_{it}", f"filled_{it}", f"filled_bad_{it}"]
    assert list(res) == want + ["acc2_final"]


def test_ab_runs_each_sampler(small, capsys):
    """One line per sampler with the JAX A/B's keys; pallas runs as the
    s-volume, so it prints the same acc2_pm at the same seeds."""
    res = bench_patchmatch.run(small, ["direct", "svolume", "pallas"],
                               iters=1, repeats=1, device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == res and len(res) == 3
    assert [r["impl"] for r in res] == ["direct", "svolume", "pallas"]
    for r in res:
        assert set(r) == {"impl", "per_view_s", "warmup_s", "acc2_pm",
                          "point"}
        assert r["point"] == "48x64x1it/2src" and 0 < r["acc2_pm"] <= 1
    assert res[2]["acc2_pm"] == res[1]["acc2_pm"]


def test_ab_knobs_reach_the_parameters(small, monkeypatch, capsys):
    """Each TSAR_AB_* knob maps to its AlgorithmParams field and reaches
    run_patchmatch_pyramid; TSAR_AB_RBF warns; a sampler that raises
    prints {"impl", "error"} and main exits 1."""
    env = {"TSAR_AB_STEP": "3.5", "TSAR_AB_DZ0": "0.25",
           "TSAR_AB_DZ0F": "0.1", "TSAR_AB_STEPPX_BUDGET": "2048",
           "TSAR_AB_BANKSF": "8", "TSAR_AB_SCHED": "4,2",
           "TSAR_AB_COLOR": "1", "TSAR_AB_RBF": "0.5"}
    extra, sched, color = bench_patchmatch.knobs_from_env(env)
    assert "TSAR_AB_RBF has no effect" in capsys.readouterr().err
    assert extra == {"svolume_step_px": 3.5, "refine_dz0_frac": 0.25,
                     "refine_dz0_frac_fine": 0.1, "svolume_budget_mb": 2048,
                     "prop_banks_fine": 8, "color_processing": True}
    assert sched == (4, 2) and color
    assert bench_patchmatch.knobs_from_env({}) == ({}, None, False)
    seen = []

    def fake_pyramid(gen, imgs, view_ids, P, params, **kw):
        seen.append((params, kw))
        raise RuntimeError("sampler failed")

    monkeypatch.setattr(pm, "run_patchmatch_pyramid", fake_pyramid)
    res = bench_patchmatch.run(small, ["svolume"], iters=2, repeats=1,
                               device="cpu", extra=extra, sched=sched,
                               color=color)
    assert res == [{"impl": "svolume",
                    "error": "RuntimeError('sampler failed')"}]
    params, kw = seen[0]
    for field, value in extra.items():
        assert getattr(params, field) == value, field
    assert params.iterations == 2 and params.ncc_impl == "svolume"
    assert kw["iterations_per_level"] == (4, 2)
    rgb = kw["imgs_color"]
    assert rgb.shape == (3, 3, 48, 64)
    torch.testing.assert_close(rgb[:, 2], 0.6 * rgb[:, 0])
    for k, v in {**env, "TSAR_BENCH_H": "48", "TSAR_BENCH_W": "64",
                 "TSAR_BENCH_VIEWS": "3", "TSAR_AB_IMPLS": "svolume"}.items():
        monkeypatch.setenv(k, v)
    assert bench_patchmatch.main(["--device", "cpu"]) == 1
    assert '"error"' in capsys.readouterr().out


def test_scaling_world_size_invariance(capsys):
    """run_count at 1 and 2 spawned gloo CPU ranks with the same 2
    references (strong scaling) gives the same summed PatchMatch cost; its
    line has bench_scaling.py:147-148's keys."""
    kw = dict(height=48, width=64, iters=1, scenes=2, cpu=True)
    one = bench_scaling.run_count(1, 2, **kw)
    two = bench_scaling.run_count(2, 2, **kw)
    assert one["cost_sum"] == two["cost_sum"] and np.isfinite(one["cost_sum"])
    assert (one["devices"], two["devices"], two["refs"]) == (1, 2, 2)
    rec = bench_scaling.record(two)
    assert list(rec) == dumped_keys(ROOT / "bench_scaling.py", "main")[:4]
    assert rec["wall_s"] > 0 and rec["depthmaps_per_s"] > 0
    lines = bench_scaling.summary([one, two], "strong", True, 48, 64)
    assert lines[0]["metric"] == "strong_scaling_efficiency"
    assert bench_scaling.rank_counts(True) == [1, 2, 4, 8]


def test_scene_spawns_one_rank_per_card(tmp_path, monkeypatch):
    """C9: on a host with two cards, `scene` without a launcher spawns two
    NCCL ranks (the kernels built once first); --sharded off, --resume
    with auto, a card named by index and the CPU run in this process."""
    for var in ("TSAR_COORDINATOR", "TSAR_NUM_PROCESSES", "TSAR_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    spawned, here, built = [], [], []
    monkeypatch.setattr(distributed, "run_ranks",
                        lambda fn, world, init, backend="gloo", args=():
                        spawned.append((fn, world, init, backend, args)))
    monkeypatch.setattr(_build, "load_library", lambda: built.append(1))
    monkeypatch.setattr(pipeline, "process_scene",
                        lambda root, params, **kw: here.append(kw))
    root = str(tmp_path)
    assert cli.main(["scene", root, "--iterations", "2"]) == 0
    fn, world, init, backend, args = spawned[0]
    assert (fn, world, backend) == (cli._scene_rank, 2, "nccl")
    assert init.startswith("file://") and args[0] == "cuda"
    assert args[1] == root and args[2].iterations == 2
    assert built == [1] and here == []
    assert cli.main(["scene", root, "--sharded", "on", "--fuse"]) == 0
    assert len(spawned) == 2 and spawned[1][4][-2:] == (True, True)
    for argv in (["--sharded", "off"], ["--resume"],
                 ["--device", "cuda:1"], ["--device", "cpu"]):
        assert cli.main(["scene", root, *argv]) == 0
    assert len(spawned) == 2
    assert [kw["sharded"] for kw in here] == [False, "auto", "auto", "auto"]
    assert [kw["device"] for kw in here] == ["cuda", "cuda", "cuda:1", "cpu"]
    assert here[1]["resume"] is True


def test_suppress_local_label_matches_jax():
    """suppress_local_label equals the JAX function exactly on a seeded
    random label image (4 labels: most pixels have >= 16 differing
    neighbours), and keeps the 2-pixel border."""
    lab = np.random.default_rng(5).integers(0, 4, (37, 53)).astype(np.int32)
    want = np.asarray(jslic.suppress_local_label(jnp.asarray(lab)))
    got = slic.suppress_local_label(torch.as_tensor(lab, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != lab).mean() > 0.2
    border = np.ones_like(lab, bool)
    border[2:-2, 2:-2] = False
    np.testing.assert_array_equal(got.numpy()[border], lab[border])


def test_slic_enforce_connectivity_matches_jax(scene):
    """slic(enforce_connectivity=True) on the scene's quarter-scale
    feature equals the JAX labels exactly, and the two passes change some
    labels of the plain segmentation."""
    gray = np.asarray(scene.images[0], np.float32)[::2, ::2]
    feat = np.array(jslic.gray_to_feature(jnp.asarray(gray)))
    want = np.asarray(jslic.slic(jnp.asarray(feat), spixel_size=6,
                                 enforce_connectivity=True).labels)
    got = slic.slic(torch.as_tensor(feat), spixel_size=6,
                    enforce_connectivity=True).labels.numpy()
    np.testing.assert_array_equal(got, want)
    plain = slic.slic(torch.as_tensor(feat), spixel_size=6).labels.numpy()
    assert (plain != got).any()


@pytest.mark.cuda
def test_cuda_crosscheck_on_card(small):
    """On the card the crosscheck holds B1 and B2 (and B3 on the direct
    sampler) to their plain versions and says "ok"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for impl in ("svolume", "direct"):
        params = bench.bench_params(small, 1, impl, True)
        check = bench.cuda_crosscheck(small, params, "cuda")
        assert check.startswith("ok: max|delta| B1"), check
        assert ("B3" in check) == (impl == "direct")


@pytest.mark.cuda
def test_bench_run_on_card():
    """bench.run at 96x128x4 on the card: the crosscheck passes and the
    accuracy keys are in range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = bench.run(make_scene(height=96, width=128, num_views=4, seed=0),
                    iters=2, repeats=1, ncc_impl="auto", small=True,
                    device="cuda")
    assert res["cuda_crosscheck"].startswith("ok")
    assert 0 < res["acc2_pm"] <= 1 and res["value"] > 0
