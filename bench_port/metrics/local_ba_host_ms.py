"""Host ms per local bundle adjustment (``optim/local_ba.local_bundle_adjustment``, one a
keyframe from the third on), the program's own ``slam::local_ba`` span in the stretch traced on
host and device. Absent where the program records no such span."""


def read(t):
    n, ns = t.host.get("slam::local_ba", (0, 0))
    if n == 0:
        return None
    return ns / 1e6 / n
