"""Seconds a job in the whole scene's maps: rank 0's time from the
barrier before `pipeline.process_scene` to its return, the card
synchronised (its last step is a collective, so every rank's maps are on
disk by then), a mean over the window's jobs (`trace["jobs"]`, the scene
driver's)."""


def read(trace: dict) -> float | None:
    jobs = [j["maps_s"] for j in trace.get("jobs", []) if "maps_s" in j]
    return sum(jobs) / len(jobs) if jobs else None
