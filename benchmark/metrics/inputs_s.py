"""Seconds a view bringing the view's inputs to the card
(``pipeline.process_view``): the upload of its images from pageable
memory and, with a prior, the dmb and weak.png reads and
``state_from_prior``; the program's `patchmatch.inputs` span, inside the
`patchmatch` stage."""

from benchmark.spans import span_per_view


def read(trace: dict) -> float | None:
    return span_per_view(trace, "patchmatch.inputs")
