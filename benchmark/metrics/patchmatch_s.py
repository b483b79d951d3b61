"""Seconds a view in the PatchMatch pyramid (``models/patchmatch``), from
the `patchmatch` span. A view from a prior without iterations marks the
span too (the lift of the prior), so the metric lists only the cells
that run the pyramid."""

from benchmark.metrics import span_per_view


def read(trace: dict) -> float | None:
    return span_per_view(trace, ("patchmatch",))
