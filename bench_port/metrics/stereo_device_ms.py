"""Device ms per frame of the kernels stereo matching launched (``stereo.stereo_match_frames``)."""

from bench_port.trace import device_ns_in


def read(t):
    if not t.device:   # no device activity traced (a run without a card)
        return None
    if t.frames <= 0 or "stereo" not in t.ranges:
        return None
    return device_ns_in(t, "stereo") / 1e6 / t.frames
