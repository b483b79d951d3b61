"""Per-layer metric readers, one file a metric, found by its name in
``BENCHMARK.json`` (``metrics/<name>.py``).

Each module has ``read(trace: dict) -> float | None``. A reader that
finds nothing to read returns None, and the harness leaves the metric
out of the result line. `trace` is what a ``--trace 1`` run recorded over
its window:

- ``views``: reference views completed in the window;
- ``window_s``: the window's seconds; ``busy_s``: seconds in which an
  operation ran on the device (the union of every kernel, copy and fill
  of the profiler's trace);
- ``spans``: seconds by stage name, summed over the views, between the
  program's stage marks (``process_view``'s `timer`) on the device's
  timeline: each mark records a CUDA event and synchronises nothing, so
  a stage's span runs from the end of the device work queued before it
  to the end of its own, host time the device waited for included;
- ``kernels``: {device operation name: [seconds, launches]};
- ``launches``: device operations of every kind (kernels, copies, fills);
- ``config``: the cell's configuration file as a dict, with its frozen
  ``plan`` and ``resolution``.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")


def span_per_view(trace: dict, stages) -> float | None:
    """Seconds a view of the named stages; None when none was marked."""
    found = [trace["spans"][s] for s in stages if s in trace["spans"]]
    if not found or not trace["views"]:
        return None
    return sum(found) / trace["views"]


def kernel_device(trace: dict, match: str) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds
    `match`."""
    secs = n = 0
    for name, (s, k) in trace["kernels"].items():
        if match in name:
            secs += s
            n += k
    return secs, n


def roofline_pct(trace: dict, match: str, least_per_view) -> float | None:
    """100 x the kernel's least seconds over its device seconds, both
    over the window's launches; `least_per_view(plan, resolution)` gives
    (least seconds, launches) of one view. None when the kernel did not
    run, or ran another number of times than the views' plan."""
    secs, n = kernel_device(trace, match)
    least, per_view = least_per_view(trace["config"]["plan"],
                                     trace["config"]["resolution"])
    if n == 0 or secs <= 0 or n != per_view * trace["views"]:
        return None
    return 100.0 * least * trace["views"] / secs
