"""Synchronisations of the host with the card a view (`.cpu()`, `.item()`,
`.tolist()`, `bool()`, `nonzero`, pageable copies, `synchronize`, ...):
the program's `host_syncs` counter over the window's views."""

from benchmark import spans


def read(trace: dict) -> float | None:
    got = spans.program(trace)
    if got is None or not trace["views"] \
            or "host_syncs" not in got["program_counters"]:
        return None
    return got["program_counters"]["host_syncs"] / trace["views"]
