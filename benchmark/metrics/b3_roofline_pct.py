"""Kernel B3's share of its roofline (``csrc/direct.cu``, the direct
sampler's multi-view cost): its least time by
``counts.b3.b3_least_seconds``, which leaves the data-dependent source
reads out (a lower bound), over its device time. Only the instances
whose channels and aggregation registers are the plan's count
(``direct_multiview_kernel<slots, CH, NB, window>``), so a run that falls
back to gray or to n_best 1 reads nothing; a plan without `channels`
(the s-volume cells) reads nothing either."""

import re

from benchmark.counts import b3
from benchmark.metrics import roofline_pct

INSTANCE = re.compile(r"direct_multiview_kernel<\s*(\d+),\s*(\d+),\s*(\d+),")


def read(trace: dict) -> float | None:
    plan = trace["config"].get("plan", {})
    if "channels" not in plan or "n_best" not in plan:
        return None
    want = b3.instance(plan)
    kernels = {}
    for name, v in trace["kernels"].items():
        m = INSTANCE.search(name)
        if m and (int(m.group(2)), int(m.group(3))) == want:
            kernels[name] = v
    return roofline_pct(dict(trace, kernels=kernels),
                        "direct_multiview_kernel", b3.b3_least_seconds)
