"""The device's idle share of the traced window, in %: 100 x (1 -
busy_s / window_s)."""


def read(trace: dict) -> float | None:
    if trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
