"""Host ms per keyframe in the keyframe pipeline's fuse loop (``mapping.process_new_keyframe``:
the neighbours read back with ``.tolist()``, then two fuses a neighbour), the program's own
``slam::fuse`` span in the stretch traced on host and device. Absent where the program records
no such span."""


def read(t):
    n, ns = t.host.get("slam::fuse", (0, 0))
    if n == 0:
        return None
    return ns / 1e6 / n
