"""Device ms per frame of the kernels the frontend's calls launched
(``frontend.extract_features_batch`` / ``extract_features``; a stereo frame counts both images)."""

from bench_port.trace import device_ns_in


def read(t):
    if not t.device:   # no device activity traced (a run without a card)
        return None
    if t.frames <= 0 or "frontend" not in t.ranges:
        return None
    return device_ns_in(t, "frontend") / 1e6 / t.frames
