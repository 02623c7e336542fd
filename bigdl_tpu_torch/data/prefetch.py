"""Lookahead iterators — the port of ``bigdl_tpu.data.prefetch``.

``prefetch_to_device`` keeps a ``size``-deep queue of batches already
handed to a non-blocking ``put`` (an asynchronous host-to-device copy), so
while step k runs, batch k+1 (and k+2 …) are in flight over PCIe.
``thread_prefetch`` runs a host producer on a thread ahead of its
consumer."""

import collections
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
D = TypeVar("D")


def prefetch_to_device(batches: Iterable[T], put: Callable[[T], D],
                       size: int = 2) -> Iterator[D]:
    """Yield ``put(batch)`` results with a ``size``-deep dispatch lookahead.

    ``put`` must be non-blocking (an asynchronous copy to the device).  ``size=2`` double-buffers; larger
    values only help when host batch *production* is bursty."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    queue = collections.deque()
    done = False
    try:
        for b in batches:
            queue.append(put(b))
            if len(queue) >= size:
                yield queue.popleft()
        while queue:
            yield queue.popleft()
        done = True
    finally:
        # as thread_prefetch: an abandoned consumer (end_when mid-epoch,
        # an exception in the training loop) must close the upstream
        # producer (a StreamingPipeline's stage threads, a RecordReader's
        # mmap) instead of leaking it per abandoned epoch
        if not done:
            close = getattr(batches, "close", None)
            if close is not None:
                close()


def thread_prefetch(batches: Iterable[T], depth: int = 2) -> Iterator[T]:
    """HOST-side lookahead: a daemon thread runs the (IO/augmentation-
    bound) batch producer up to ``depth`` batches ahead of the consumer.
    Complements :func:`prefetch_to_device` (device-transfer lookahead):
    native gathers/augmentation release the GIL, so producer and the
    dispatch loop genuinely overlap.  Exceptions re-raise at the
    consumer's next pull."""
    import queue as _queue
    import threading as _threading

    if depth < 1:
        raise ValueError(f"thread_prefetch depth must be >= 1, got {depth}")
    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    _END, _ERR = object(), object()
    stop = _threading.Event()

    def _put(item) -> bool:
        # A plain q.put would block forever once the consumer abandons the
        # generator (end_when mid-epoch, an exception in the training
        # loop), leaking the thread + buffered batches + upstream iterator
        # per abandoned epoch — poll the stop flag instead.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def produce():
        try:
            for b in batches:
                if not _put(b):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — surfaces at consumer
            _put((_ERR, e))
        finally:
            close = getattr(batches, "close", None)
            if stop.is_set() and close is not None:
                close()

    t = _threading.Thread(target=produce, name="bigdl-tpu-torch-prefetch",
                          daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _ERR):
                raise item[1]
            yield item
    finally:
        stop.set()
