"""Background batch prefetcher (counterpart of
`mobileposer_tpu/data/prefetch.py`).

The training host assembles numpy batches (gather, pad, combo mask) while
the card runs the previous step; a daemon thread feeding a bounded queue
overlaps the two. Host threads only: the analogue of the reference's
`DataLoader(num_workers=8)` without processes (reference data.py /
config.py:9).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

_SENTINEL = object()


class BatchPrefetcher:
    """Wrap any batch iterable; prefetch up to `depth` batches ahead.

    `close()` stops the worker even when the consumer abandons iteration
    early (without it, a worker blocked on a full queue would pin the
    generator and its batches for the process lifetime)."""

    def __init__(self, batches: Iterable, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        try:
            for batch in it:
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:       # surface worker errors to consumer
            self._error = e
        finally:
            # the sentinel must arrive even when the queue is full, or the
            # consumer would block in __next__ forever: wait for room with
            # a stop-aware timeout
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        """Stop the worker; safe to call several times and after the end."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
