"""Background-thread prefetching for the host data pipeline.

Counterpart of ``diffbir_tpu/dataset/prefetch.py``: the batch synthesis
(decode, crop, degradation, the batch transform) runs in a worker thread
ahead of the training loop, through a bounded queue, and ``device_put``
stages each batch on the card there, so that ``next()`` returns tensors
already on the device. ``close()`` does not deadlock (the worker's puts and
the consumer's gets are timed and re-check the stop flag), and an error in
the worker is raised on the consumer's side. The torch ``device_put`` is
``to_device``: arrays and tensors go to pinned memory and are copied with
``non_blocking``, so the copy overlaps the step the card is running; other
values (the prompts) pass through.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


def to_device(device) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """A ``device_put`` for ``PrefetchIterator``: each numpy array or tensor
    of a batch dict as a tensor on ``device`` (through pinned memory and a
    non-blocking copy when it is a CUDA device), the rest unchanged."""
    device = torch.device(device)

    def put(batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            if torch.is_tensor(v):
                if device.type == "cuda":
                    v = v.pin_memory().to(device, non_blocking=True)
                else:
                    v = v.to(device)
            out[k] = v
        return out

    return put


_SENTINEL = object()  # worker-done marker (distinct from any batch)


class PrefetchIterator:
    def __init__(
        self,
        batch_iter: Iterator,
        transform: Optional[Callable] = None,
        device_put: Optional[Callable] = None,
        depth: int = 2,
    ):
        """batch_iter yields host batches; ``transform`` (e.g. the
        Real-ESRGAN batch transform) runs in the worker thread; ``device_put``
        stages the result (``to_device``: pinned memory, then an asynchronous
        copy to the card)."""
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._done = False  # consumer-side terminal state

        def worker():
            try:
                for batch in batch_iter:
                    if self._stop.is_set():
                        return
                    if transform is not None:
                        batch = transform(batch)
                    if device_put is not None:
                        batch = device_put(batch)
                    # bounded put that stays responsive to close(): a plain
                    # blocking put deadlocks when close() drains and the
                    # worker then fills the queue again (incl. the sentinel)
                    while not self._stop.is_set():
                        try:
                            self._q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except Exception as e:  # surfaced on the consumer side
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        # Timed get that re-checks the terminal flag: close() from another
        # thread drains the queue (sentinel included) and joins the worker,
        # so an untimed get() here could block forever with no producer left.
        while True:
            if self._done:
                if self._err is not None:
                    raise self._err
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _SENTINEL:
                self._done = True
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item

    def close(self):
        """Stop the worker and discard any staged batches (frees the device
        memory they hold). Safe to call more than once; __next__ afterwards
        raises StopIteration instead of blocking."""
        self._stop.set()
        self._done = True
        # drain so a worker blocked in put() can observe _stop and exit;
        # join BEFORE the final drain so no stale batch is re-enqueued after
        # we last looked
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
