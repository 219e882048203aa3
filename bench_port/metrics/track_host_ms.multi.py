"""Host ms per frame inside the batched tracking step (``tracking.fused_track_multi``)."""

from bench_port.trace import host_ns_of


def read(t):
    n, ns = host_ns_of(t, "track_multi")
    if n == 0 or t.frames <= 0:
        return None
    return ns / 1e6 / t.frames
