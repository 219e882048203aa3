"""Host ms per call of the stereo keyframe's depth landmarks (``mapping.spawn_depth_landmarks``, one
a keyframe), the program's own ``slam::depth_spawn`` span in the stretch traced on host and device.
Absent where the program records no such span."""


def read(t):
    n, ns = t.host.get("slam::depth_spawn", (0, 0))
    if n == 0:
        return None
    return ns / 1e6 / n
