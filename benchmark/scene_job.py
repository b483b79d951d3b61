"""The scene driver: the runs of a cell whose traffic mix says
``"driver": "scene"`` (``run.main`` hands them here).

    python3 benchmark/run.py --workload eth3d2k.scene4 --seed <n> \
        --seconds <s> --trace <0|1>

What a user runs is ``tsar scene <dir> --fuse`` on a host with one card a
rank: every rank calls ``pipeline.process_scene`` (its sharded branch:
``parallel/scene_sharded.py``, phases A-E on the rank's slice of the
views, then ``mesh.gather_views``) and rank 0 then ``pipeline.fuse_scene``
(``models/fusion.py``), as ``cli._scene_rank`` does. A run:

1. builds the kernel library once, here, before any rank starts (as
   ``cli.cmd_scene`` does), and starts the cell's `chips` rank processes
   once, one a card, joined in one process group (NCCL on cards, gloo on
   the CPU) with a timeout on every collective;
2. rank 0 renders the configuration's scene on its card
   (``benchmark/scene.py``; the texture from the configuration's
   `texture_seed`, so that every seed gives the program the same images
   and the same work) and writes it in the on-disk contract that
   ``pipeline.load_scene`` reads with the benchmark's own writers
   (``scene_files.py``), keeping the truth for the check;
3. runs one whole job that is not timed; everything up to its end is
   `setup_s`;
4. runs jobs back to back, one caller in a closed loop, until
   ``--seconds`` have passed and the job running then has ended: job k
   draws from ``seed * 1000003 + k`` (``traffic.view_seed`` with the job
   as the index); rank 0 deletes the previous job's ``results/`` before
   it, while the other ranks wait on the host (so that the check reads
   what the last job wrote, and no job's 2 GB of files outlive the next
   job on the disk), and times it from a barrier to the fused PLY on
   disk, the card synchronised. The deletions' seconds are taken out of
   the window (and, with ``--trace 1``, out of every card's traced
   window and its idle seconds): they are the harness's work, not the
   user's. The ranks keep the program's own intra-op threads, as the
   CLI's ranks do. With ``--trace 1`` every rank profiles its own
   window (``torch.profiler``), with marks ``between_jobs``, ``maps`` and
   ``fusion`` (on ranks 1.. ``fusion`` closes their wait for rank 0's
   fusion), and the program's tracer records its spans and counters
   there (``tsar_mvs_tpu_torch/trace.py``: phase D's
   ``weak_texture.*``, ``ransac.*`` and ``fill.border_check``), with the
   calls of ``process_scene`` and ``fuse_scene`` inside spans
   ``scene.maps`` and ``scene.fusion``, so that the tracer counts every
   host synchronisation of the job; each rank sends its summary
   (``spans.summary``) to the parent, which sums them;
5. reads every card's peak memory and every rank's loaded modules, frees
   the program's state, and checks the last job's maps of every view
   (``reference/check.py``) and its fused cloud (``reference/cloud.py``)
   against the cell's limits.

A job that has not ended 5 minutes after it began, or in which a rank
raises or dies, ends the run: the parent kills every rank, counts the
job's views as failed and still returns its result, `correct` false.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
JOB_DEADLINE_S = 300.0


class RankFailure(RuntimeError):
    """A rank raised, died or missed its deadline."""


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- ranks


class _Rank:
    """One rank's side of a run: its card, its part of the process group,
    and (rank 0) the scene and its truth."""

    def __init__(self, rank: int, world: int, spec: dict):
        self.rank, self.world, self.spec = rank, world, spec
        self.marks: list[tuple[float, str]] = []
        self.prof = None
        self.waiting = False
        self.undo = []

    def mark(self, name: str) -> None:
        self.marks.append((time.time_ns() / 1e3, name))

    def sync(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> dict:
        import torch
        import torch.distributed as dist
        from benchmark import scene as bench_scene
        from benchmark import scene_files
        spec = self.spec
        if spec["device"] == "cuda":
            self.dev = torch.device(
                "cuda", self.rank % torch.cuda.device_count())
            torch.cuda.set_device(self.dev)
        else:
            self.dev = torch.device("cpu")
        dist.init_process_group(
            backend=spec["backend"], init_method=spec["init_method"],
            world_size=self.world, rank=self.rank,
            timeout=timedelta(seconds=spec["timeout_s"]))
        if spec.get("fault"):
            self.plant(spec["fault"])
        from tsar_mvs_tpu_torch import _build
        if self.dev.type == "cuda":
            _build.load_library()
        cfg = spec["config"]
        self.scene_dir = Path(spec["work"]) / "scene"
        self.names = [f"{i:08d}" for i in range(cfg["images"])]
        info = {"kind": (torch.cuda.get_device_name(self.dev)
                         if self.dev.type == "cuda" else "cpu")}
        if self.rank == 0:
            W, H = cfg["resolution"]
            geo = cfg["scene"]
            t0 = time.perf_counter()
            sd = bench_scene.make_scene(
                H, W, cfg["images"], geo["texture_seed"], self.dev,
                weak_fraction=geo["weak_fraction"],
                arc_radius=geo["arc_radius"],
                arc_span_deg=geo["arc_span_deg"],
                pair_top_k=cfg["pair_top_k"])
            self.sync()
            info["render_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            info["input_bytes"] = scene_files.write_scene(
                self.scene_dir, self.names, sd.images.cpu().numpy(), sd.K,
                sd.R, sd.t, sd.depth_min, sd.depth_max, sd.pair)
            info["write_s"] = time.perf_counter() - t0
            self.truth = SimpleNamespace(
                K=sd.K, R=sd.R, t=sd.t, depth=sd.depth.cpu(),
                normal_world=sd.normal_world.cpu(),
                weak_mask=sd.weak_mask.cpu())
            self.sources = {
                v: [j for j, _ in sd.pair[v][:cfg["sources_per_view"]]]
                for v in range(cfg["images"])}
            self.rects = [
                (r.origin, r.eu, r.ev)
                for r in bench_scene.rectangles(geo["weak_fraction"])]
            del sd
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        dist.barrier()
        return info

    def plant(self, name: str) -> None:
        from benchmark import scene_faults
        self.undo.append(scene_faults.plant(name, self.rank, self.world))

    def unplant(self) -> None:
        while self.undo:
            self.undo.pop()()

    def job(self, seed: int, traced: bool, fuse: bool = True) -> dict:
        import torch.distributed as dist
        from tsar_mvs_tpu_torch import pipeline, trace
        from tsar_mvs_tpu_torch.config import AlgorithmParams
        if self.waiting:
            self.mark("fusion")
            self.waiting = False
        if traced and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            self.marks = []
            trace.reset()
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.dev.type == "cuda"
                else ProfilerActivity.CPU])
            self.prof.__enter__()
        params = AlgorithmParams(**self.spec["config"]["algorithm"])
        dist.barrier()
        self.sync()
        self.mark("between_jobs")
        t0 = time.perf_counter()
        with trace.span("scene.maps"):
            pipeline.process_scene(self.scene_dir, params, seed=seed,
                                   write_ply=False, device=self.dev.type)
        self.sync()
        t_maps = time.perf_counter()
        self.mark("maps")
        if self.rank != 0:
            self.waiting = True
            return {}
        if not fuse:
            return {"maps_s": t_maps - t0}
        with trace.span("scene.fusion"):
            pipeline.fuse_scene(self.scene_dir, device=self.dev)
        self.sync()
        t_end = time.perf_counter()
        self.mark("fusion")
        return {"maps_s": t_maps - t0, "fusion_s": t_end - t_maps,
                "job_s": t_end - t0}

    def clear(self) -> float:
        """Rank 0 deletes the last job's ``results/``, so that the check
        reads what the next job writes; returns its seconds."""
        t0 = time.perf_counter()
        shutil.rmtree(self.scene_dir / "results", ignore_errors=True)
        return time.perf_counter() - t0

    def fuse_again(self) -> dict:
        """Rank 0 fuses the maps on disk again (the fusion faults'
        readings)."""
        from tsar_mvs_tpu_torch import pipeline
        (self.scene_dir / "results" / "TSAR_fused.ply").unlink(
            missing_ok=True)
        t0 = time.perf_counter()
        pipeline.fuse_scene(self.scene_dir, device=self.dev)
        self.sync()
        return {"fusion_s": time.perf_counter() - t0}

    def window_end(self) -> dict:
        import torch
        from benchmark import run, spans
        from tsar_mvs_tpu_torch import trace
        if self.waiting:
            self.mark("fusion")
            self.waiting = False
        red = program = None
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            red = run.reduce_profile(self.prof, self.marks)
            self.prof = None
            program = spans.summary(trace.collect())
            trace.reset()
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"peak": peak, "forbidden": run.forbidden_loaded(),
                "profile": red, "program": program}

    def check(self, limits: dict) -> dict:
        """Rank 0: the last job's maps and cloud against the truth."""
        import torch
        from benchmark.reference import check, cloud
        t0 = time.perf_counter()
        results = self.scene_dir / "results"
        truth = SimpleNamespace(**vars(self.truth))
        truth.depth = truth.depth.to(self.dev)
        maps = {v: check.read_maps(results / n)
                for v, n in enumerate(self.names)}
        measured = check.measure(truth, self.sources, maps, self.dev)
        numbers = dict(measured["numbers"])
        numbers.update(cloud.measure(truth, self.rects, self.sources,
                                     results / "TSAR_fused.ply", self.dev))
        correct, compared = check.judge(numbers, limits)
        job_bytes = sum(f.stat().st_size for f in results.rglob("*")
                        if f.is_file())
        del truth
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"correct": correct, "compared": compared,
                "numbers": numbers, "per_view": measured["per_view"],
                "depth_acc2_pct": measured["depth_acc2_pct"],
                "job_bytes": job_bytes,
                "check_s": time.perf_counter() - t0}

    COMMANDS = ("job", "clear", "fuse_again", "plant", "unplant",
                "window_end", "check")

    def handle(self, msg: tuple):
        if msg[0] not in self.COMMANDS:
            raise ValueError(f"unknown command {msg[0]!r}")
        return getattr(self, msg[0])(*msg[1:])


def merge_programs(programs: list[dict]) -> dict:
    """The ranks' `spans.summary` dicts summed: span seconds and counters
    added, B5 calls joined."""
    out = {"program_spans": {}, "program_counters": {}, "b5_calls": []}
    for p in programs:
        for name, (s, own) in p["program_spans"].items():
            acc = out["program_spans"].setdefault(name, [0.0, 0.0])
            acc[0] += s
            acc[1] += own
        for name, n in p["program_counters"].items():
            out["program_counters"][name] = \
                out["program_counters"].get(name, 0) + n
        out["b5_calls"] += p["b5_calls"]
    return out


def rank_main(rank: int, world: int, spec: dict, conn) -> None:
    """A rank process: set up, then answer the parent's commands until it
    says "exit". An exception goes to the parent, and the rank ends."""
    sys.path.insert(0, spec["root"])
    os.environ["USE_FLAX"] = "0"
    try:
        worker = _Rank(rank, world, spec)
        conn.send(("ok", worker.setup()))
        while True:
            msg = conn.recv()
            if msg[0] == "exit":
                break
            conn.send(("ok", worker.handle(msg)))
    except Exception:  # every failure goes to the parent
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise SystemExit(1)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------- parent


class Ranks:
    """The parent's side of the rank processes: each command goes to the
    ranks named, and every answer has to come before the deadline."""

    def __init__(self, world: int, spec: dict, deadline_s: float):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world, self.deadline_s = world, deadline_s
        self.conns, self.procs = [], []
        for r in range(world):
            here, there = ctx.Pipe()
            p = ctx.Process(target=rank_main, args=(r, world, spec, there),
                            daemon=True)
            p.start()
            there.close()
            self.conns.append(here)
            self.procs.append(p)

    def wait(self, ranks) -> list:
        """The answers of `ranks` in rank order; raises RankFailure on an
        error, a rank that died, or the deadline."""
        from multiprocessing.connection import wait
        end = time.monotonic() + self.deadline_s
        answers, pending = {}, set(ranks)
        while pending:
            left = end - time.monotonic()
            if left <= 0:
                raise RankFailure(f"ranks {sorted(pending)} gave no answer "
                                  f"within {self.deadline_s:.0f} s")
            waitables = [self.conns[r] for r in pending] + [
                self.procs[r].sentinel for r in pending]
            ready = wait(waitables, timeout=left)
            for r in sorted(pending):
                if self.conns[r] in ready:
                    try:
                        status, payload = self.conns[r].recv()
                    except EOFError:
                        raise RankFailure(f"rank {r} closed its pipe")
                    if status == "error":
                        raise RankFailure(f"rank {r} raised:\n{payload}")
                    answers[r] = payload
                    pending.discard(r)
                elif self.procs[r].sentinel in ready:
                    raise RankFailure(f"rank {r} ended with exit code "
                                      f"{self.procs[r].exitcode}")
        return [answers[r] for r in sorted(answers)]

    def ask(self, msg: tuple, ranks=None) -> list:
        ranks = list(range(self.world)) if ranks is None else list(ranks)
        for r in ranks:
            self.conns[r].send(msg)
        return self.wait(ranks)

    def close(self, kill: bool = False) -> None:
        """Ends every rank and waits for it: an "exit" first, then a kill
        for any that has not ended within 30 s (at once with `kill`)."""
        if not kill:
            for c, p in zip(self.conns, self.procs):
                if p.is_alive():
                    try:
                        c.send(("exit",))
                    except OSError:
                        pass
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        for c in self.conns:
            c.close()


class Session:
    """A scene on `world` ranks, set up once, and the commands a run or a
    calibration gives it."""

    def __init__(self, config: dict, device: str = "cuda",
                 world: int = 1, backend: str | None = None,
                 fault: str | None = None,
                 deadline_s: float = JOB_DEADLINE_S):
        self.config, self.device, self.world = config, device, world
        self.backend = backend or ("nccl" if device == "cuda" else "gloo")
        self.work = Path(tempfile.mkdtemp(prefix="tsar_bench_scene_"))
        spec = {"root": str(ROOT), "work": str(self.work),
                "device": device, "backend": self.backend,
                "init_method": f"file://{self.work}/pg",
                "timeout_s": deadline_s, "config": config, "fault": fault}
        self.ranks = Ranks(world, spec, deadline_s)
        try:
            self.info = self.ranks.wait(range(world))[0]
        except BaseException:
            self.close(kill=True)
            raise

    def job(self, seed: int, traced: bool = False, fuse: bool = True) -> dict:
        """A whole job (rank 0's answer, with `clear_s`): rank 0 deletes
        the last job's results first, while the other ranks wait on the
        host (a barrier would spin a kernel on their cards)."""
        clear_s = self.ranks.ask(("clear",), ranks=[0])[0]
        return dict(self.ranks.ask(("job", seed, traced, fuse))[0],
                    clear_s=clear_s)

    def fuse_again(self) -> dict:
        return self.ranks.ask(("fuse_again",), ranks=[0])[0]

    def plant(self, name: str) -> None:
        self.ranks.ask(("plant", name))

    def unplant(self) -> None:
        self.ranks.ask(("unplant",))

    def window_end(self) -> list[dict]:
        return self.ranks.ask(("window_end",))

    def check(self, limits: dict) -> dict:
        return self.ranks.ask(("check", limits), ranks=[0])[0]

    def close(self, kill: bool = False) -> None:
        try:
            self.ranks.close(kill=kill)
        finally:
            shutil.rmtree(self.work, ignore_errors=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: dict | None = None,
             limits: dict | None = None, t_start: float | None = None,
             world: int | None = None, backend: str | None = None,
             fault: str | None = None,
             deadline_s: float = JOB_DEADLINE_S) -> dict:
    """One run of a scene cell; returns the result line's dict (with
    `forbidden_modules` and `measured`, which `run.main` takes out).
    `config`, `limits`, `world` (default: the cell's chips) and `backend`
    replace the cell's (tests run a small scene on CPU ranks); `fault`
    plants one of ``scene_faults`` in every rank."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import metrics as readers
    from benchmark import run, traffic
    from benchmark.reference import check
    t_start = run.T_START if t_start is None else t_start
    spec, cell, cell_config = run.load_cell(workload)
    config = config or cell_config
    limits = limits or check.load_limits(workload)
    world = world or cell["chips"]
    on_card = device == "cuda"
    V = config["images"]
    if on_card:
        from tsar_mvs_tpu_torch import _build
        t0 = time.perf_counter()
        _build.load_library()
        say(f"# kernel library ready in {time.perf_counter() - t0:.3f} s")

    jobs: list[dict] = []
    attempted = failed = 0
    setup_s = window_s = None
    ends: list[dict] = []
    checked = None
    failure = None
    session = None
    try:
        session = Session(config, device, world, backend, fault, deadline_s)
        say(f"# scene on {world} rank(s) ({session.backend}): rendered in "
            f"{session.info['render_s']:.3f} s, written in "
            f"{session.info['write_s']:.3f} s")
        attempted = failed = V  # the untimed job, until it has ended
        warm = session.job(traffic.view_seed(seed, -1))
        attempted = failed = 0
        setup_s = time.perf_counter() - t_start
        say(f"# set-up {setup_s:.3f} s (untimed job {warm['job_s']:.3f} s: "
            f"maps {warm['maps_s']:.3f}, fusion {warm['fusion_s']:.3f}) on "
            f"{run.power_limit() if on_card else 'cpu'}")
        w0 = time.perf_counter()
        try:
            while not jobs or time.perf_counter() - w0 < seconds:
                attempted += V
                jobs.append(session.job(traffic.view_seed(seed, len(jobs)),
                                        trace))
        except RankFailure:
            failed += V
            raise
        finally:
            # The deletions of the jobs' files are the harness's work.
            window_s = time.perf_counter() - w0 - sum(j["clear_s"]
                                                      for j in jobs)
        ends = session.window_end()
        checked = session.check(limits)
    except RankFailure as err:
        failure = str(err)
        say(f"# run failed: {failure}")
    finally:
        if session is not None:
            session.close(kill=failure is not None)

    found = set(run.forbidden_loaded())
    for e in ends:
        found |= set(e["forbidden"])
    say("# job seconds: " + json.dumps(
        [{k: round(x, 4) for k, x in j.items()} for j in jobs]))
    correct = checked is not None and checked["correct"] and failed == 0
    if checked is not None:
        inputs = session.info.get("input_bytes", 0)
        say(f"# bytes written: {checked['job_bytes']} a job, "
            f"{checked['job_bytes'] * (len(jobs) + 1) + inputs} by this "
            f"run's {len(jobs) + 1} jobs and {inputs} of scene files")
        say(f"# output check {checked['check_s']:.3f} s; cloud: " + json.dumps(
            {k: checked["numbers"].get(k) for k in
             ("cloud_points", "cloud_tau")}) + "; per view: " + json.dumps(
            {v: {k: x if x is None else round(x, 7) for k, x in m.items()}
             for v, m in checked["per_view"].items()}))

    metrics: dict[str, dict] = {}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed}
    profiles = [e["profile"] for e in ends if e.get("profile")]
    programs = [e["program"] for e in ends if e.get("program")]
    # The traced window opens in the first job, after its deletion, and
    # holds the later ones: each card was idle through them (rank 0
    # deleted after its fusion, the others waited on the host from their
    # maps on), so they leave its window and its idle seconds.
    cleared = sum(j["clear_s"] for j in jobs[1:])
    for r, p in enumerate(profiles):
        stage = "between_jobs" if r == 0 else "fusion"
        p["window_s"] -= cleared
        p["idle_by_stage"][stage] = p["idle_by_stage"].get(stage, 0.0) \
            - cleared
    if not trace:
        values = {"views_per_s": (V * len(jobs) / window_s if window_s
                                  else None),
                  "depth_acc2": (checked["depth_acc2_pct"] if checked
                                 else None),
                  "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]) \
                    and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    elif profiles and failure is None:
        kernels: dict[str, list] = {}
        for p in profiles:
            for name, (s, n) in p["kernels"].items():
                k = kernels.setdefault(name, [0.0, 0])
                k[0] += s
                k[1] += n
        tr = {"views": V * len(jobs), "jobs": jobs,
              "window_s": sum(p["window_s"] for p in profiles)
              / len(profiles),
              "busy_s": sum(p["busy_s"] for p in profiles) / len(profiles),
              "kernels": kernels,
              "launches": sum(p["launches"] for p in profiles),
              "config": config}
        if programs:
            tr.update(merge_programs(programs))
        say("# trace: " + json.dumps({k: v for k, v in tr.items()
                                       if k != "config"}))
        say("# idle by rank: " + json.dumps(
            [{"rank": r, "busy_s": p["busy_s"], "window_s": p["window_s"],
              "idle_by_stage": p["idle_by_stage"]}
             for r, p in enumerate(profiles)]))
        for m in spec["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = readers.load(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": session.info["kind"] if session and session.info else
        ("unknown" if on_card else "cpu"),
        "count": world,
        "memory_peak_bytes": max((e["peak"] for e in ends), default=0)}
    if trace and profiles and failure is None:
        result["device"].update(busy_s=tr["busy_s"],
                                window_s=tr["window_s"])
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        idle = sorted(((f"rank{r}.{name}", s)
                       for r, p in enumerate(profiles)
                       for name, s in p["idle_by_stage"].items()),
                      key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[name[:160], s] for name, (s, _) in top],
            "idle_gaps": [[name, s] for name, s in idle[:10]]}
    result["forbidden_modules"] = sorted(found)
    result["measured"] = ({"numbers": checked["numbers"],
                           "per_view": checked["per_view"],
                           "depth_acc2_pct": checked["depth_acc2_pct"]}
                          if checked else None)
    result["check"] = (checked["compared"] if checked else
                       {"views_failed": {"value": failed, "limit": 0}})
    return result
