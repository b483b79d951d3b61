"""Seconds a job in rank 0's `pipeline.fuse_scene` (``models/fusion.py``,
the PLY's write included), the card synchronised, a mean over the
window's jobs (`trace["jobs"]`, the scene driver's)."""


def read(trace: dict) -> float | None:
    jobs = [j["fusion_s"] for j in trace.get("jobs", []) if "fusion_s" in j]
    return sum(jobs) / len(jobs) if jobs else None
