"""Host ms per frame inside the port's pose optimization (``optim/pose_only.pose_optimization``,
two calls a tracked frame), read from the program's own ``slam::pose_opt`` span in the stretch
traced on host and device. Absent where the program records no such span."""


def read(t):
    n, ns = t.host.get("slam::pose_opt", (0, 0))
    if n == 0 or t.frames <= 0:
        return None
    return ns / 1e6 / t.frames
