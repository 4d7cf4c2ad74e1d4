"""Host-to-device pipeline: double-buffered prefetch -- the PyTorch
counterpart of ``dtf_tpu/data/pipeline.py`` ``DevicePrefetcher``, its
``shard_for_process`` (from ``data/base.py``) and ``all_processes_max``
over the ``torch.distributed`` process group.

A background thread keeps ``buffer_size`` batches already on the device
while the device computes.  On CUDA each batch is copied from pinned
host memory on a side stream; the consumer's stream waits on the copy's
event before it touches the batch, and ``record_stream`` tells the
caching allocator that the compute stream uses the memory, so it is not
handed out again while a step still reads it.  On the CPU the batches
are wrapped as tensors, without a copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from dtf_tpu_torch.data.base import shard_for_process  # noqa: F401


def all_processes_max(value: int, group=None) -> int:
    """Max of a host-local int across the processes of ``group`` (the
    default group when None), the identity at one process: sharded eval
    pipelines with uneven per-process record counts agree on one
    collective batch count with it.  An int64 ``all_reduce(MAX)`` on
    the group's device: this process's card under NCCL, else the CPU."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return int(value)
        group = dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return int(value)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


class DevicePrefetcher:
    """Wraps a host iterator of numpy tuples; yields tuples of tensors on
    ``device``.  A worker error is re-raised by ``__next__``, on every
    call after it."""

    def __init__(self, it: Iterator, device, buffer_size: int = 2):
        self._it = it
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._err = None
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _transfer(self, batch):
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in batch]
        if self._stream is None:
            return tuple(host), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            out = tuple(t.pin_memory().to(self._device, non_blocking=True)
                        for t in host)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._it:
                if not self._put(self._transfer(batch)):
                    return
        except Exception as e:  # surfaced on next()
            self._err = e
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        # the worker's terminal None is put once: latch it, so a call
        # after the end or an error re-raises instead of blocking
        if not self._done:
            item = self._q.get()
            if item is not None:
                tensors, ready = item
                if ready is not None:
                    compute = torch.cuda.current_stream(self._device)
                    compute.wait_event(ready)
                    for t in tensors:
                        t.record_stream(compute)
                return tensors
            self._done = True
        if self._err is not None:
            raise self._err
        raise StopIteration

    def close(self) -> None:
        """Stop the worker and drop the buffered batches."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._done = True
