"""Kernel B1's share of its roofline (``csrc/ncc.cu``, the s-volume
matching cost): its least time by ``counts.kernels.b1_least_seconds``,
which leaves the data-dependent volume reads out (a lower bound), over
its device time."""

from benchmark.counts import kernels
from benchmark.metrics import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "svol_ncc", kernels.b1_least_seconds)
