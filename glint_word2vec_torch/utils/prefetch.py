"""Background prefetch of host batches (own copy of
``glint_word2vec_tpu/utils/prefetch.py``).

PyTorch launches are asynchronous, so the training loop runs ahead of the
device; what is left serial is producing the next batch group on the
host. :func:`prefetch` moves that to a daemon thread with a small bounded
queue, so the windowing and stacking of group ``g+1`` overlap the device
work of group ``g``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a daemon thread, keeping up to ``depth`` items
    ready. An exception in the producer is raised again at the consumer;
    a consumer that stops early releases the producer."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # A bounded put that notices the consumer leaving, so an abandoned
        # producer never blocks forever on a full queue.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # raised again on the consumer side
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
