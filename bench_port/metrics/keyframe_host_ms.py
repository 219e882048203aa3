"""Host ms per keyframe inside the keyframe pipeline (``Engine._insert_keyframe``: insertion,
``mapping.process_new_keyframe``, local BA, the vocabulary and the BoW row)."""

from bench_port.trace import host_ns_of


def read(t):
    n, ns = host_ns_of(t, "keyframe")
    if n == 0:
        return None
    return ns / 1e6 / n
