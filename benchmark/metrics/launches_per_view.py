"""Device operations of every kind (kernels, copies, fills) a view, from
the profiler's trace."""


def read(trace: dict) -> float | None:
    if not trace["views"] or not trace["launches"]:
        return None
    return trace["launches"] / trace["views"]
