"""Background prefetch of decoded batches.

The worker's train loop is a strict alternation without this: decode batch n
on the host, then run the device step, host idle while the TPU computes.  A
single background thread pulling the decode generator into a bounded queue
overlaps the two — the decode work (numpy + the C++ codec + file reads, all
GIL-releasing) runs while the device step is in flight, which is the whole
reason the reference routes ingest through tf.data's threaded C++ pipeline
(SURVEY.md §2 #14, §3.3).  Depth bounds host memory: at most ``depth``
decoded batches exist beyond the one being consumed.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_DONE = object()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(
    iterable: Iterable, depth: int = 2, name: str = "edl-prefetch"
) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, keeping up to ``depth`` items
    decoded ahead.  Exceptions raised by the producer re-raise at the
    consumer's next pull (fail-loud: a malformed record must kill the task,
    not vanish into a thread).  ``depth < 1`` returns the iterable unchanged.
    ``name`` labels the producer thread (the worker passes
    ``prefetch:<task_id>``) so thread dumps and locksan reports attribute
    ingest threads to the task that owns them.

    A consumer that abandons iteration early (task failure mid-shard)
    cancels the producer: the generator's close/GC sets the cancel event,
    and the producer — which only ever blocks on the queue with a short
    timeout — notices and exits, dropping its buffered batches.  Without
    that, every abandoned task would pin a thread plus ``depth`` decoded
    batches forever.
    """
    if depth < 1:
        return iter(iterable)
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def _put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce() -> None:
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — transported to consumer
            _put(_Failure(e))
            return
        _put(_DONE)

    def _consume() -> Iterator:
        # Lazy start (ADVICE r4 #1): a generator abandoned before its first
        # next() never executes its body, so its finally never runs — an
        # eagerly started producer would then spin on 0.1 s put-retries
        # forever, pinning ``depth`` decoded batches.  Starting the thread
        # on the first pull means no pull, no thread, no leak.
        threading.Thread(target=_produce, name=name, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            cancelled.set()

    return _consume()
