"""Seconds a view in the host stages: weak-texture detection and SLIC
(``models/weak_texture``, ``ops/slic``), from the `weak_texture` and
`slic` spans."""

from benchmark.metrics import span_per_view


def read(trace: dict) -> float | None:
    return span_per_view(trace, ("weak_texture", "slic"))
