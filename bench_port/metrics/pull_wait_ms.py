"""Host ms per frame that the engine spends on a batch's pull (``Engine._finish_pull``: the wait
for the pull's event and the copy out of pinned memory), the program's own ``slam::pull_wait``
span in the stretch traced on host and device: the time the host waits on the device. Absent
where the program records no such span."""


def read(t):
    n, ns = t.host.get("slam::pull_wait", (0, 0))
    if n == 0 or t.frames <= 0:
        return None
    return ns / 1e6 / t.frames
