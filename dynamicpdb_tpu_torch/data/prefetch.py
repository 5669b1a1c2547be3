"""Asynchronous host -> device batch prefetching.

Port of ``dynamicpdb_tpu/data/prefetch.py``: a worker thread takes the
host batches of an iterator and places them on the device while the
consumer runs the step on the batch before, ``buffer_size`` batches ahead
(2 = double buffering).

On a CUDA device the default placement copies each batch from pinned
memory on a side stream (``CudaPlace``): the worker pins the batch, enqueues
the copies on the side stream, records an event after them and waits for
it, so the pinned source lives until its copy has landed. The consumer
makes its current stream wait on that event and marks every tensor as used
by that stream (``record_stream``), so the caching allocator cannot hand
a buffer to the side stream's next copy while the step still reads it.
On the CPU a batch's arrays become tensors, with no stream and no pinning.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()
THREAD_NAME = "DevicePrefetcher"


def _tensors(batch: dict, fn) -> dict:
    """``fn`` applied to every array or tensor value of ``batch``; other
    values (names) pass through."""
    return {k: fn(torch.as_tensor(v))
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


class _InFlight:
    """A batch copied on a side stream, with the event recorded after its
    copies."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch: dict, event, device):
        self.batch = batch
        self.event = event
        self.device = device


class CudaPlace:
    """Pinned-memory copies of a batch's arrays to ``device`` on a side
    stream; returns an ``_InFlight`` for the consumer to wait on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def __call__(self, batch: dict) -> _InFlight:
        host = _tensors(batch, lambda t: t.pin_memory())
        with torch.cuda.stream(self.stream):
            placed = _tensors(host, lambda t: t.to(self.device,
                                                   non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        event.synchronize()  # the pinned source stays alive until here
        return _InFlight(placed, event, self.device)


def default_place(device) -> Callable:
    """The placement ``DevicePrefetcher`` uses when given none."""
    device = torch.device(device)
    if device.type == "cuda":
        return CudaPlace(device)
    return lambda batch: _tensors(batch, lambda t: t.to(device))


def _receive(item):
    """The consumer's side of a placement: an in-flight CUDA batch is
    ordered before the current stream's work and kept alive for it."""
    if not isinstance(item, _InFlight):
        return item
    stream = torch.cuda.current_stream(item.device)
    stream.wait_event(item.event)
    for v in item.batch.values():
        if isinstance(v, torch.Tensor):
            v.record_stream(stream)
    return item.batch


class DevicePrefetcher:
    """Wraps a host-batch iterator; yields device-resident batches.

    Args:
        it: source iterator of host batches (dicts of numpy arrays or
            tensors).
        buffer_size: number of in-flight device batches (2 = double buffer).
        place: batch -> device batch; default ``default_place(device)``.
        device: the device of the default placement ("cuda" by default).

    Abandoning the iterator mid-epoch must call ``close()`` (or use the
    prefetcher as a context manager): otherwise the worker stays blocked
    in its put, holding ``buffer_size`` device batches for the life of the
    process.
    """

    def __init__(self, it: Iterable, buffer_size: int = 2,
                 place: Callable | None = None, device="cuda"):
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._place = place or default_place(device)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def put(item) -> bool:
            # poll the put so close() can unblock it
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in it:
                    if not put(self._place(batch)):
                        return
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                # the sentinel must be delivered (or close() observed): a
                # fast producer can fill the buffer and finish before the
                # consumer takes its first batch
                put(_SENTINEL)

        self._thread = threading.Thread(target=worker, name=THREAD_NAME,
                                        daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0):
        """Stop the worker and release the buffered device batches."""
        self._stop.set()
        self._drain()  # so a blocked put can observe the stop flag
        self._thread.join(timeout=timeout)
        self._drain()  # a put that landed while the worker stopped

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield _receive(item)


def prefetch_to_device(it: Iterable, buffer_size: int = 2, place=None,
                       device="cuda") -> DevicePrefetcher:
    return DevicePrefetcher(it, buffer_size=buffer_size, place=place,
                            device=device)
