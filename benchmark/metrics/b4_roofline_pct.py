"""Kernel B4's share of its roofline (``csrc/wmf.cu``, the WMF weighted
median plane), one launch a WMF pass."""

from benchmark.counts import kernels
from benchmark.metrics import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "wmf_median", kernels.b4_least_seconds)
