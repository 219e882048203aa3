"""Host ms per frame inside the per-frame tracking step (``tracking.fused_track_step`` called
on its own, not inside ``fused_track_multi``)."""

from bench_port.trace import host_ns_of


def read(t):
    n, ns = host_ns_of(t, "track_step", outside="track_multi")
    if n == 0 or t.frames <= 0:
        return None
    return ns / 1e6 / t.frames
