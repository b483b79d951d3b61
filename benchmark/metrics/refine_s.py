"""Seconds a view in the refinement (``models/tsar``): the spans from
`confidence` to `finalize`."""

from benchmark.metrics import span_per_view

STAGES = ("confidence", "wmf_mark", "ransac", "fill", "wmf_final",
          "finalize")


def read(trace: dict) -> float | None:
    return span_per_view(trace, STAGES)
