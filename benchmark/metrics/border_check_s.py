"""Seconds a view in the border check (``models/tsar.py::border_veto``:
the fake depth, its readbacks, the host check and the veto): the
program's `fill.border_check` span, inside the `fill` stage."""

from benchmark.spans import span_per_view


def read(trace: dict) -> float | None:
    return span_per_view(trace, "fill.border_check")
