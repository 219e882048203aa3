"""The 95th percentile of the host time of the client's per-frame call (the pose returned),
over every frame of the traced run's window (the profiled stretch follows the window)."""

from bench_port.harness import percentile


def read(t):
    if len(t.frame_ms) < 20:
        return None
    return percentile(t.frame_ms, 95.0)
