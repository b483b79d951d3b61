#!/usr/bin/env python3
"""The benchmark of ``tsar_mvs_tpu_torch``, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on, from
the root of a checkout, and prints one JSON line last on standard output
(`correct`, `attempted`, `failed`, `metrics`, `device`, with ``--trace
1`` `breakdown`, then `check`). It finds the card or fails; it never
falls back to the CPU. A run:

1. renders the cell's scene on the card (``benchmark/scene.py``; its
   texture from the configuration's `texture_seed`, so that every seed
   gives the program the same images and the same work; in colour where
   its `scene` says `"color": true`) and builds the program's ``Scene``
   in memory, with the colour images beside the gray; a mix with a prior
   writes ``APD/<name>/...`` for every view, its noise drawn from the
   seed;
2. warms up on one reference view that is not timed (the process's first
   pyramid, the first cuSOLVER/cuBLAS calls, the kernel library load);
   everything up to here is `setup_s`;
3. drives ``pipeline.process_view`` on the mix's views in a closed loop
   with one caller until ``--seconds`` have passed and every view of the
   scene has been sent at least once (the check compares every view, and
   a scene of many views can outlast the window), each view with its own
   generator seeded from the seed and its place in the loop, its maps
   written under ``TMPDIR``; with ``--trace 1`` under ``torch.profiler``
   and with a `timer` at the program's stage marks that records a CUDA
   event and synchronises nothing;
4. reads the device's peak memory, checks that nothing of JAX or the JAX
   package is loaded, frees the program's state, and compares the last
   maps of every view with the truth (``benchmark/reference/check.py``)
   against the cell's limits (``benchmark/limits/<workload>.json``).

Every build and cache stays inside the checkout: the port builds its
kernel library under ``build/tsar_mvs_tpu_torch/``, and the harness points
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` under ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tsar_mvs_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(workload: str) -> tuple[dict, dict, dict]:
    """(spec, cell, configuration) of `workload` from BENCHMARK.json."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    return spec, cell, config


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def io_write_bytes() -> int | None:
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        return None
    return None


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default and `statistics.quantiles(method="inclusive")`)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Tracer:
    """The `--trace 1` side of a run: the program's stage marks, taken
    without a device synchronisation, so that the traced window overlaps
    host and device as the untraced one does. Each mark records a CUDA
    event on the current stream (the host clock off the card) and the
    host's wall-clock instant in the profiler's time base (microseconds
    since the epoch). After the window, `spans` gives the seconds between
    consecutive marks on the device's timeline, by the stage a mark
    closes; the instants lay the device's idle time against the stage the
    host was in."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.marks: list[tuple[float, str]] = []
        self.points: list[tuple[str, object]] = []

    def view_start(self) -> None:
        self.timer("view")

    def timer(self, name: str) -> None:
        import torch
        self.marks.append((time.time_ns() / 1e3, name))
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.points.append((name, ev))
        else:
            self.points.append((name, time.perf_counter()))

    def spans(self) -> dict[str, float]:
        """Seconds by stage over the window; the time from a view's last
        mark to the next view's start lies between views and is left out.
        Call after the device has finished the window's work."""
        out: dict[str, float] = {}
        for (_, a), (name, b) in zip(self.points, self.points[1:]):
            if name == "view":
                continue
            dt = a.elapsed_time(b) / 1e3 if self.on_card else b - a
            out[name] = out.get(name, 0.0) + dt
        return out


def reduce_profile(prof, marks: list[tuple[float, str]]) -> dict:
    """Device seconds and launches by operation name, the busy seconds,
    the traced window and the idle seconds by the host stage they fell
    in, from the profiler's raw device events and the tracer's marks
    (microseconds since the epoch)."""
    from torch.autograd import DeviceType
    kernels: dict[str, list] = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t0, dt = e.start_ns() / 1e3, e.duration_ns() / 1e3
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += dt / 1e6
            k[1] += 1
            intervals.append((t0, t0 + dt))
    marks.sort()
    if not marks:
        return {"kernels": kernels, "busy_s": 0.0, "window_s": 0.0,
                "idle_by_stage": {}, "launches": 0}
    w0, w1 = marks[0][0], marks[-1][0]
    # Stage intervals: a mark closes the stage it names; the time from an
    # "artifacts" mark to the next view's start lies between views.
    stages = []
    for (a, _), (b, name_b) in zip(marks, marks[1:]):
        stages.append((a, b, "between_views" if name_b == "view"
                       else name_b))
    intervals = sorted((max(a, w0), min(b, w1)) for a, b in intervals
                       if b > w0 and a < w1)
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle: dict[str, float] = {}
    si = 0
    for a, b in gaps:
        while si < len(stages) and stages[si][1] <= a:
            si += 1
        j = si
        while j < len(stages) and stages[j][0] < b:
            lo, hi = max(a, stages[j][0]), min(b, stages[j][1])
            if hi > lo:
                idle[stages[j][2]] = idle.get(stages[j][2], 0.0) \
                    + (hi - lo) / 1e6
            j += 1
    return {"kernels": kernels, "busy_s": busy / 1e6,
            "window_s": (w1 - w0) / 1e6, "idle_by_stage": idle,
            "launches": sum(n for _, n in kernels.values())}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: dict | None = None,
             limits: dict | None = None,
             t_start: float | None = None, min_views: int = 0) -> dict:
    """One run of `workload`; returns the result line's dict. `config`
    and `limits` replace the cell's files (tests run a small copy on the
    CPU), `t_start` is when set-up began (default: the process start);
    the window runs on past `seconds` until every view of the scene, and
    at least `min_views` views, have been sent (`calibrate.py` reads one
    rotation a seed)."""
    import torch
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import scene as bench_scene
    from benchmark import traffic
    from benchmark import metrics as readers
    from benchmark.reference import check
    from tsar_mvs_tpu_torch import pipeline
    from tsar_mvs_tpu_torch.config import AlgorithmParams
    from tsar_mvs_tpu_torch.utils import scene_io

    def say(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    t_start = T_START if t_start is None else t_start
    spec, cell, cell_config = load_cell(workload)
    config = config or cell_config
    limits = limits or check.load_limits(workload)
    mix = traffic.load(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    written0 = io_write_bytes()
    work = Path(tempfile.mkdtemp(prefix=f"tsar_bench_{workload}_"))
    try:
        # 1. The scene, rendered on the device.
        W, H = config["resolution"]
        V = config["images"]
        geo = config["scene"]
        t0 = time.perf_counter()
        sd = bench_scene.make_scene(
            H, W, V, geo["texture_seed"], dev,
            weak_fraction=geo["weak_fraction"],
            arc_radius=geo["arc_radius"], arc_span_deg=geo["arc_span_deg"],
            pair_top_k=config["pair_top_k"], color=geo.get("color", False))
        sync()
        render_s = time.perf_counter() - t0
        names = [f"{i:08d}" for i in range(V)]
        # A colour scene's images as `Scene.load_color` would read them,
        # on the host: -color_processing then finds them in memory.
        scene = pipeline.Scene(
            root=work / "scene", names=names, images=sd.images.cpu().numpy(),
            P=sd.P, depth_min=sd.depth_min, depth_max=sd.depth_max,
            pair=scene_io.PairFile(neighbors=sd.pair),
            images_color=(None if sd.images_color is None
                          else sd.images_color.cpu().numpy()))
        if mix["prior"] is not None:
            traffic.write_priors(mix, sd, names, scene.root, seed)
        truth = SimpleNamespace(
            K=sd.K, R=sd.R, t=sd.t, depth=sd.depth.cpu(),
            normal_world=sd.normal_world.cpu(), weak_mask=sd.weak_mask.cpu())
        sources = {v: [j for j, _ in sd.pair[v][:config["sources_per_view"]]]
                   for v in range(V)}
        del sd
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = AlgorithmParams(**config["algorithm"])

        def view(index: int, out_dir: Path, timer=None) -> None:
            ref = traffic.view_order(V, index)
            gen = torch.Generator(device=dev).manual_seed(
                traffic.view_seed(seed, index))
            pipeline.process_view(scene, ref, params, generator=gen,
                                  out_dir=out_dir,
                                  pm_iterations=mix["pm_iterations"],
                                  write_ply=False, device=dev, timer=timer)

        # 2. Warm-up: one view, not timed, its maps apart.
        view(-1, work / "warmup")
        sync()
        setup_s = time.perf_counter() - t_start
        say(f"# set-up {setup_s:.3f} s (render {render_s:.3f} s) on "
            f"{power_limit() if on_card else 'cpu'}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")

        # 3. The window: a closed loop with one caller.
        tracer = Tracer(on_card) if trace else None
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA] if on_card
                           else [ProfilerActivity.CPU])
            prof.__enter__()
        times, failed, index = [], 0, 0
        last_done: dict[int, Path] = {}
        sync()
        min_views = max(min_views, V)
        w0 = time.perf_counter()
        try:
            while (time.perf_counter() - w0 < seconds
                   or index < min_views):
                ref = traffic.view_order(V, index)
                out_dir = work / "results" / names[ref]
                # The check reads what this call writes, never an earlier
                # instance's maps.
                shutil.rmtree(out_dir, ignore_errors=True)
                if tracer:
                    tracer.view_start()
                t0 = time.perf_counter()
                try:
                    view(index, out_dir, tracer.timer if tracer else None)
                    sync()
                except Exception:  # a failed view is counted, not fatal
                    failed += 1
                    say(traceback.format_exc())
                else:
                    times.append(time.perf_counter() - t0)
                    last_done[ref] = out_dir
                index += 1
        finally:
            window_s = time.perf_counter() - w0
            t0 = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
            stop_s = time.perf_counter() - t0
        attempted = index

        # 4. After the window.
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        found = forbidden_loaded()
        t0 = time.perf_counter()
        red = reduce_profile(prof, tracer.marks) if prof is not None \
            else None
        spans = tracer.spans() if tracer is not None else None
        if red is not None:
            say(f"# trace reduced in {time.perf_counter() - t0:.3f} s "
                f"(profiler stopped in {stop_s:.3f} s)")
        del prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        written = io_write_bytes()
        view_bytes = sum(f.stat().st_size for f in
                         (work / "warmup").iterdir())
        prior_bytes = sum(f.stat().st_size for f in
                          (work / "scene").rglob("*") if f.is_file())
        io = (written - written0 if written is not None
              and written0 is not None else "not readable")
        say(f"# bytes written: {view_bytes} a view, "
            f"{view_bytes * (len(times) + 1) + prior_bytes} by this run's "
            f"{len(times) + 1} views and {prior_bytes} of prior files "
            f"(/proc/self/io write_bytes: {io})")
        say("# view seconds: " + json.dumps([round(t, 4) for t in times]))
        t0 = time.perf_counter()
        maps = {v: (check.read_maps(last_done[v]) if v in last_done
                    else None) for v in range(V)}
        measured = check.measure(truth, sources, maps, dev)
        correct, compared = check.judge(measured["numbers"], limits)
        correct = correct and failed == 0
        say(f"# output check {time.perf_counter() - t0:.3f} s over the "
            f"last maps of {V - measured['numbers']['views_missing']} "
            f"views; per view: " + json.dumps(
                {v: {k: x if x is None else round(x, 7)
                     for k, x in m.items()}
                 for v, m in measured["per_view"].items()}))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    metrics: dict[str, dict] = {}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if not trace:
        values = {"views_per_s": len(times) / window_s,
                  "view_s_p95": percentile(times, 95) if times else None,
                  "depth_acc2": measured["depth_acc2_pct"],
                  "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]) \
                    and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        tr = {"views": len(times), "window_s": red["window_s"],
              "busy_s": red["busy_s"], "spans": spans,
              "kernels": red["kernels"], "launches": red["launches"],
              "config": config}
        say("# trace: " + json.dumps({k: v for k, v in tr.items()
                                       if k != "config"}))
        for m in spec["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = readers.load(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=red["busy_s"],
                                window_s=red["window_s"])
        top = sorted(red["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
        idle = sorted(red["idle_by_stage"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[name[:160], s] for name, (s, _) in top],
            "idle_gaps": [[name, s] for name, s in idle[:10]]}
    result["forbidden_modules"] = found
    result["measured"] = measured
    result["check"] = compared
    return result


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark"
                                         / "triton")
    os.environ["USE_FLAX"] = "0"
    try:
        _, cell, _ = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import scene_job, traffic
    drive = (scene_job.run_cell
             if traffic.load(cell["traffic"]).get("driver") == "scene"
             else run_cell)
    result = drive(args.workload, args.seed, args.seconds, bool(args.trace))
    found = result.pop("forbidden_modules")
    result.pop("measured")
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
