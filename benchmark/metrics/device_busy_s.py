"""Seconds a view in which an operation ran on the device (the union of
every kernel, copy and fill over the traced window, over the views): the
device's own time, steadier than the host clock's `views_per_s`."""


def read(trace: dict) -> float | None:
    if not trace["views"] or trace["busy_s"] <= 0:
        return None
    return trace["busy_s"] / trace["views"]
