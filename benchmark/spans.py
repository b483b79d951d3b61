"""The program's own spans and counters, read after a traced window.

The port records them in memory (``tsar_mvs_tpu_torch/trace.py``) while
torch.profiler records, so the window of a ``--trace 1`` run carries them:
each span's name, parent, view, host start and end on the profiler's
clock and its seconds on the device's timeline, and the counters. The
readers take them in four summaries (`summary`): ``program_spans``
({span name: [seconds, self seconds]} summed over the window),
``program_counters`` ({name: total}), ``b5_calls`` (each B5 call's
work, the attributes of its `ransac.fit` span) and ``view_s`` (each
`view` span's seconds on the host's clock, in order). A checkout whose program
has no tracer gives nothing, and the readers then leave their metric out.
"""

from __future__ import annotations


def summary(collected: dict) -> dict:
    """The readers' summaries of the program's `trace.collect()`."""
    spans: dict[str, list[float]] = {}
    for s in collected["spans"]:
        acc = spans.setdefault(s["name"], [0.0, 0.0])
        acc[0] += s["seconds"]
        acc[1] += s["self_s"]
    return {"program_spans": spans,
            "program_counters": dict(collected["counters"]),
            "b5_calls": [s["attrs"] for s in collected["spans"]
                         if s["name"] == "ransac.fit"],
            "view_s": [(s["end_us"] - s["start_us"]) / 1e6
                       for s in collected["spans"] if s["name"] == "view"]}


def program(trace: dict) -> dict | None:
    """The program's summaries: those `trace` holds (a recorded trace),
    else those of the program's tracer in this process; None when the
    program has no tracer."""
    if "program_spans" in trace:
        return trace
    try:
        from tsar_mvs_tpu_torch import trace as tracer
    except ImportError:
        return None
    return summary(tracer.collect())


def span_per_view(trace: dict, name: str) -> float | None:
    """Seconds a view in the program's spans called `name`; None when the
    program has no tracer or recorded no such span."""
    got = program(trace)
    if got is None or not trace["views"] \
            or name not in got["program_spans"]:
        return None
    return got["program_spans"][name][0] / trace["views"]


def device_intervals(prof) -> list[tuple[float, float]]:
    """(start, end) in microseconds since the epoch of every device
    operation in a torch.profiler trace."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t0 = e.start_ns() / 1e3
            out.append((t0, t0 + e.duration_ns() / 1e3))
    return out


def idle_gaps(intervals, w0: float, w1: float) -> list[tuple[float, float]]:
    """The stretches of [w0, w1] in which no interval ran."""
    gaps, prev = [], w0
    for a, b in sorted(intervals):
        if b <= w0 or a >= w1:
            continue
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def idle_by_span(intervals, spans: list[dict],
                 outside: str = "between_views") -> dict[str, float]:
    """Idle device seconds by the innermost span open on the host at that
    instant, over the window from the first span's start to the last
    one's end; `outside` takes the time in no span. `intervals` are the
    device's operations, `spans` the program's (host `start_us` and
    `end_us` on one clock, nested as the program opened them)."""
    if not spans:
        return {}
    w0 = min(s["start_us"] for s in spans)
    w1 = max(s["end_us"] for s in spans)
    # Elementary segments between span boundaries, each with its
    # innermost open span: a sweep over the boundaries in time order,
    # a span's end before a later span's start at the same instant.
    events = sorted([(s["start_us"], 1, -s["end_us"], i)
                     for i, s in enumerate(spans)]
                    + [(s["end_us"], 0, 0, i) for i, s in enumerate(spans)])
    segments, stack, t_prev = [], [], w0
    for t, opens, _, i in events:
        if t > t_prev:
            segments.append((t_prev, t, spans[stack[-1]]["name"] if stack
                             else outside))
            t_prev = t
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    out: dict[str, float] = {}
    si = 0
    for a, b in idle_gaps(intervals, w0, w1):
        while si < len(segments) and segments[si][1] <= a:
            si += 1
        j = si
        while j < len(segments) and segments[j][0] < b:
            lo, hi = max(a, segments[j][0]), min(b, segments[j][1])
            if hi > lo:
                name = segments[j][2]
                out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
            j += 1
    return out
