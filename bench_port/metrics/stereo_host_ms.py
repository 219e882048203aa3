"""Host ms per frame inside stereo matching (``stereo.stereo_match_frames``: the gated dense match,
its mutual test and the SAD refinement), the program's own ``slam::stereo_match`` span in the
stretch traced on host and device. Absent where the program records no such span."""


def read(t):
    n, ns = t.host.get("slam::stereo_match", (0, 0))
    if n == 0 or t.frames <= 0:
        return None
    return ns / 1e6 / t.frames
