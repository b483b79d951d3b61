"""Kernel B6's share of its roofline (``csrc/halfpass.cu``, the
checkerboard half-pass: selection, proposals and accepts), counting no
taken position (a lower bound)."""

from benchmark.counts import kernels
from benchmark.metrics import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "halfpass_", kernels.b6_least_seconds)
