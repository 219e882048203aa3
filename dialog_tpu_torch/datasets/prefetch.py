"""Background-thread prefetch for dataset iterators.

The reference example mains decode each image synchronously on the
tracking thread (canonical ``Examples/Monocular/mono_tum.cc`` loop); with
the device pipeline asynchronous, a synchronous PNG decode becomes the
per-frame critical path. This wraps any iterator with a small
producer-consumer queue so decode overlaps device work — the host-side
analog of double buffering (SURVEY.md §2.1 dataset-driver row:
"prefetching loaders"). A copy of the reference's, with its fix for a
producer that finishes against a full queue.

Host-only: imports the standard library alone.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


class Prefetcher:
    """Iterate ``src`` on a daemon thread, ``depth`` items ahead.

    Exceptions in the producer re-raise in the consumer at the point of
    iteration. A drained Prefetcher keeps raising StopIteration (iterator
    protocol); ``close()`` (or use as a context manager) unblocks and stops
    the producer early so a consumer that stops mid-stream doesn't leave
    the thread pinned on a full queue holding the source iterator open.
    """

    def __init__(self, src: Iterable[T], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._closed = threading.Event()
        self._done = False

        def run():
            try:
                for item in src:
                    while not self._closed.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._closed.is_set():
                        return
            except BaseException as e:   # noqa: BLE001 — re-raised in consumer
                self._err = e
            finally:
                # block until the sentinel fits (a full queue MUST still get
                # its _END or the consumer hangs); bail only on close()
                while not self._closed.is_set():
                    try:
                        self._q.put(_END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def close(self) -> None:
        """Stop the producer and release the source iterator."""
        self._closed.set()
        while True:   # drain so the producer's pending put can finish
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=2.0)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._done = True
            self._t.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(src: Iterable[T], depth: int = 4) -> Prefetcher:
    """Convenience wrapper: ``for ts, img in prefetch(tum.iter_mono(d)):``"""
    return Prefetcher(src, depth)
