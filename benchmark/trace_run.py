#!/usr/bin/env python3
"""A `--trace 1` run of one cell with the program's spans from the start.

    python3 benchmark/trace_run.py --workload <name> --seed <n> \
        --seconds <s>

Runs ``benchmark/run.py --trace 1`` (its result line, last on standard
output, is that run's) with the program's tracer
(``tsar_mvs_tpu_torch/trace.py``) switched on before the warm-up view,
and prints three more lines to standard error:

- ``# setup spans:`` the warm-up view's spans and the kernel library's
  load (``library_load``, with ``library_load.build`` when nvcc ran), in
  the order they began: [name, seconds, depth], seconds on the device's
  timeline once CUDA is up. The spans are then dropped, so that the
  window's readers see the window alone;
- ``# idle by span:`` the device's idle seconds over the window by the
  innermost program span open on the host at that instant
  (``spans.idle_by_span``), the 10 largest, and ``between_views`` for
  the time outside every view;
- ``# program:`` the readers' summaries of the window's spans and
  counters (``spans.summary``: ``program_spans``, ``program_counters``,
  ``b5_calls``), which a recorded trace of ``benchmark/tests/data``
  carries beside the ``# trace:`` line's numbers.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark import spans  # noqa: E402


def depths(spans_: list[dict]) -> list[int]:
    by_id, out = {}, []
    for s in spans_:
        d = by_id.get(s["parent"], -1) + 1
        by_id[s["id"]] = d
        out.append(d)
    return out


def main(argv=None) -> int:
    from tsar_mvs_tpu_torch import trace
    args = sys.argv[1:] if argv is None else list(argv)
    if "--trace" in args:
        print("trace_run: runs with --trace 1 only", file=sys.stderr)
        return 2
    captured: dict = {}
    reduce = run.reduce_profile

    class Tracer(run.Tracer):
        def view_start(self) -> None:
            if not self.points:  # the window's first view
                got = trace.collect()["spans"]
                print("# setup spans: " + json.dumps(
                    [[s["name"], round(s["seconds"], 6), d]
                     for s, d in zip(got, depths(got))]),
                    file=sys.stderr, flush=True)
                trace.reset()
            super().view_start()

    def reduce_profile(prof, marks):
        captured["intervals"] = spans.device_intervals(prof)
        return reduce(prof, marks)

    run.Tracer, run.reduce_profile = Tracer, reduce_profile
    trace.on()
    try:
        rc = run.main(args + ["--trace", "1"])
    finally:
        trace.off()
        run.Tracer, run.reduce_profile = Tracer.__base__, reduce
    got = trace.collect()
    if "intervals" in captured:
        idle = spans.idle_by_span(captured["intervals"], got["spans"])
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        print("# idle by span: " + json.dumps(
            [[name, round(s, 6)] for name, s in top]), file=sys.stderr,
            flush=True)
    print("# program: " + json.dumps(spans.summary(got)), file=sys.stderr,
          flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
