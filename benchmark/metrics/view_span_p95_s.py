"""The 95th percentile of a view's seconds in `process_view`: the
program's `view` spans, start to end on the host's clock, over the
window's views. `view_s_p95` under a traced window, for the cells whose
untraced runs spread too widely for that metric's bound."""

from benchmark.run import percentile
from benchmark.spans import program


def read(trace: dict) -> float | None:
    got = program(trace)
    if got is None or not got.get("view_s"):
        return None
    return percentile(got["view_s"], 95)
