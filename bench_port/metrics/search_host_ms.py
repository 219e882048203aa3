"""Host ms per frame inside the tracking step's projection searches: the motion-model search with
its fallbacks (``slam::motion_search``) and the local-map search (``slam::local_map_search``:
the local landmark set and ``track_local_map_match``), the program's own spans in the stretch
traced on host and device. Absent where the program records neither."""

SPANS = ("slam::motion_search", "slam::local_map_search")


def read(t):
    rows = [t.host[k] for k in SPANS if k in t.host]
    if not rows or t.frames <= 0:
        return None
    return sum(ns for _, ns in rows) / 1e6 / t.frames
