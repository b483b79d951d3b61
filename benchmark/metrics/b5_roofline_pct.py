"""Kernel B5's share of its roofline (``csrc/ransac.cu``, the region
RANSAC of a view in one call): its least time, summed call by call over
the work each call's `ransac.fit` span records (``counts/b5.py``), over
the device seconds of the `ransac_` kernels. None where B5 did not
launch or the program recorded no call."""

from benchmark import spans
from benchmark.counts.b5 import b5_least_seconds
from benchmark.metrics import kernel_device


def read(trace: dict) -> float | None:
    secs, n = kernel_device(trace, "ransac_")
    got = spans.program(trace)
    if n == 0 or secs <= 0 or got is None or not got["b5_calls"]:
        return None
    return 100.0 * b5_least_seconds(got["b5_calls"]) / secs
