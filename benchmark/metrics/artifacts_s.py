"""Seconds a view writing the artifacts (``pipeline``, ``utils/dmb``,
``utils/display``): the `artifacts` span."""

from benchmark.metrics import span_per_view


def read(trace: dict) -> float | None:
    return span_per_view(trace, ("artifacts",))
