"""Kernels the device ran per frame tracked in the traced window (copies and sets left out)."""

from bench_port.trace import is_kernel


def read(t):
    if not t.device:   # no device activity traced (a run without a card)
        return None
    if t.frames <= 0:
        return None
    return sum(1 for e in t.device if is_kernel(e.name)) / t.frames
