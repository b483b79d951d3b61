"""Kernel B2's share of its roofline (``csrc/warp.cu``, the s-volume
build): 2 B a voxel written at the scene-shared plane counts."""

from benchmark.counts import kernels
from benchmark.metrics import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "warp_build", kernels.b2_least_seconds)
