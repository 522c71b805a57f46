"""Host-side data pipeline: background prefetch and device placement.

Port of the JAX package's ``data/pipeline.py``, shutdown fix included: a
stop-aware put (a plain blocking ``put`` on a full queue would wedge
``close()``), ``close()`` draining the queue and joining the worker, and
a clear error from ``next()`` after ``close()`` or after a worker error
instead of a hang.

The reference's ``sharding=`` becomes ``device=``: a batch (a dict of
arrays) is placed on that device by the worker thread. On a CUDA device
each array goes through pinned host memory and a non-blocking copy on
the pipeline's own stream; the batch carries an event recorded after its
copies, and ``next()`` makes the consumer's current stream wait on it
(and marks each tensor as used there), so the consumer never reads a
batch before its copy lands and the allocator never reuses its memory
early. Without ``device`` batches pass through as the source made them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch


class _Placed:
    """A batch on the card and the event its copies completed at."""

    def __init__(self, batch: dict, ready):
        self.batch = batch
        self.ready = ready


class DataPipeline:
    def __init__(self, source: Iterator[Any], device=None,
                 prefetch: int = 2):
        self._source = source
        self._device = None if device is None else torch.device(device)
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device is not None
                        and self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._dead: Optional[str] = None   # why __next__ can't proceed
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch):
        if self._device is None:
            return batch
        if self._stream is None:
            return {k: torch.as_tensor(np.ascontiguousarray(v)).to(
                        self._device) for k, v in batch.items()}
        with torch.cuda.stream(self._stream):
            out = {k: torch.as_tensor(np.ascontiguousarray(v))
                   .pin_memory().to(self._device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return _Placed(out, ready)

    def _put(self, item) -> bool:
        """Stop-aware put: a plain blocking ``put`` on a full queue
        deadlocks shutdown (the consumer is gone, nothing ever drains),
        so block in short slices and re-check the stop flag between
        them. Returns False when stopped without enqueueing."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                if not self._put(self._place(batch)):
                    return
        except Exception as e:  # surface errors on the consumer side
            self._put(e)
            return
        self._put(StopIteration())

    def __iter__(self):
        return self

    def __next__(self):
        if self._dead == "exhausted":
            raise StopIteration            # iterator protocol: stay done
        if self._dead is not None:
            # after a worker error or close() the queue never refills --
            # a bare q.get() would hang forever
            raise RuntimeError(f"DataPipeline is closed ({self._dead})")
        item = self._q.get()
        if isinstance(item, StopIteration):
            self._dead = "exhausted"
            raise item
        if isinstance(item, Exception):
            self._dead = f"worker raised {type(item).__name__}"
            raise item
        if isinstance(item, _Placed):
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(item.ready)
            for t in item.batch.values():
                t.record_stream(stream)
            return item.batch
        return item

    def close(self):
        """Idempotent shutdown: stop the worker (a stop-aware put never
        wedges on a full queue), drain whatever it enqueued, and join so
        no producer thread outlives the pipeline."""
        self._stop.set()
        if self._dead is None:
            self._dead = "close() called"
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
