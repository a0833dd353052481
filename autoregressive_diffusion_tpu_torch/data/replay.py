"""Replay buffers: decouple the env's clip rate from the training step rate.

Counterpart of autoregressive_diffusion_tpu/data/replay.py. One background
producer thread steps the env into a ring buffer while the training loop
samples batches from it uniformly, so the card never waits for a fresh clip
and every clip the env makes is still used; `stats()` reports how often an
item is reused.

Exactly one thread touches the card: a `transform` that does device work
(the VAE encode) runs on the CONSUMER thread. The producer only steps the
env into a small bounded queue of raw items, and the consumer drains and
transforms them between training steps (`ReplayLoader` with
main_thread_transform=True, the default when a transform is given;
`DeviceReplay.ingest`). Producer errors are re-raised on the consumer side.

  * ReplayLoader -- the ring lives on the host in numpy; each batch is a
    host copy that the training loop uploads.
  * DeviceReplay -- the rings are torch tensors on the card; an insert is an
    in-place write of one slot, and batches are gathered on the card by slot
    index (train/train_state.py::make_replay_train_step), so only the index
    matrix crosses to the card once the buffer is warm. The write is queued
    on the consumer thread's stream behind any train step that still reads
    the slot, so it cannot overwrite data a queued step needs.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class ReplayLoader:
    """Iterate batches sampled from a host ring buffer that a background
    thread keeps filling from `generator`.

    generator  -- yields tuples of array-likes (e.g. (frames, actions,
                  reward) from GymDataGenerator), of fixed shapes and dtypes.
    transform  -- optional fn(item tuple) -> tuple, applied before storage;
                  runs on the consumer thread unless main_thread_transform
                  is False.
    capacity   -- ring size in items. Memory = capacity * item nbytes.
    min_fill   -- batches are not served until this many items arrived.
    """

    def __init__(self, generator, batch_size: int, capacity: int = 2048,
                 min_fill: Optional[int] = None, transform: Optional[Callable] = None,
                 seed: int = 0, main_thread_transform: bool = True):
        if capacity < batch_size:
            raise ValueError(f"capacity {capacity} < batch_size {batch_size}")
        self.generator = generator
        self.batch_size = batch_size
        self.capacity = capacity
        self.min_fill = max(batch_size, min_fill if min_fill is not None
                            else min(capacity, 2 * batch_size))
        self.transform = transform
        self._rng = np.random.default_rng(seed)
        self._buffers: Optional[list] = None   # one ndarray per tuple field
        self._count = 0          # items ever produced
        self._drawn = 0          # items ever served
        self._lock = threading.Lock()
        self._has_data = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._producer_done = False
        self._consumer_transform = transform is not None and main_thread_transform
        self._pending: Optional[queue.Queue] = (
            queue.Queue(maxsize=8) if self._consumer_transform else None)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # ---- producer ----------------------------------------------------------

    def _alloc(self, item: Sequence[np.ndarray]):
        self._buffers = [np.empty((self.capacity,) + np.asarray(f).shape,
                                  dtype=np.asarray(f).dtype) for f in item]

    def _produce(self):
        try:
            for item in self.generator:
                if self._stop.is_set():
                    return
                if self._consumer_transform:
                    # the blocking put pauses the env while the consumer lags
                    while not self._stop.is_set():
                        try:
                            self._pending.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    continue
                if self.transform is not None:
                    item = self.transform(item)
                self._store(item)
        except BaseException as e:  # re-raised on the consumer side
            with self._lock:
                self._error = e
                self._has_data.notify_all()
        finally:
            with self._lock:
                self._producer_done = True
                self._has_data.notify_all()

    def _store(self, item):
        item = tuple(np.asarray(f) for f in item)
        with self._lock:
            if self._buffers is None:
                self._alloc(item)
            slot = self._count % self.capacity
            for buf, field in zip(self._buffers, item):
                buf[slot] = field
            self._count += 1
            self._has_data.notify_all()

    # ---- consumer ----------------------------------------------------------

    def _ingest(self, max_items: Optional[int] = None):
        """Drain queued raw items, transform them on this thread, store."""
        if not self._consumer_transform:
            return
        done = 0
        while max_items is None or done < max_items:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                return
            self._store(self.transform(item))
            done += 1

    def __iter__(self) -> Iterator:
        while True:
            self._ingest()
            batch = None
            with self._has_data:
                if self._error is not None:
                    raise RuntimeError("replay producer failed") from self._error
                n = min(self._count, self.capacity)
                drained = self._producer_done and self._pending_empty()
                if n < self.min_fill and not drained:
                    pass  # keep filling below
                elif n >= self.batch_size:
                    idx = self._rng.choice(n, size=self.batch_size, replace=False)
                    batch = tuple(buf[idx].copy() for buf in self._buffers)
                    self._drawn += self.batch_size
                elif drained:
                    return  # the generator is too short to ever serve a batch
            if batch is not None:
                yield batch
                continue
            # still filling: wait without spinning the core the producer needs
            # (in consumer-transform mode the consumer must keep ingesting)
            if self._consumer_transform:
                time.sleep(0.05)
            else:
                with self._has_data:
                    if (self._error is None and self._count < self.min_fill
                            and not self._producer_done):
                        self._has_data.wait(timeout=1.0)

    def _pending_empty(self) -> bool:
        return self._pending is None or self._pending.empty()

    def stats(self) -> dict:
        with self._lock:
            produced, drawn = self._count, self._drawn
        return {"produced": produced, "drawn": drawn,
                "reuse_factor": drawn / max(produced, 1),
                "buffered": min(produced, self.capacity)}

    def stop(self):
        self._stop.set()
        with self._lock:
            self._has_data.notify_all()


class DeviceReplay:
    """Replay buffer whose rings are tensors on `device`.

    generator -- yields raw item tuples (e.g. (frames, actions, reward)).
    transform -- fn(raw item) -> tuple of tensors or arrays to store (e.g.
                 the clip's VAE latents and its actions); runs on the
                 consumer thread, inside ingest().
    """

    def __init__(self, generator, transform: Callable, batch_size: int,
                 capacity: int = 512, min_fill: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        if capacity < batch_size:
            raise ValueError(f"capacity {capacity} < batch_size {batch_size}")
        self.batch_size = batch_size
        self.capacity = capacity
        self.min_fill = max(batch_size, min_fill if min_fill is not None
                            else min(capacity, 2 * batch_size))
        self.transform = transform
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._bufs: Optional[list] = None
        self._count = 0
        self._drawn = 0
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._producer_done = False
        self._pending: queue.Queue = queue.Queue(maxsize=8)
        self._generator = generator
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._generator:
                if self._stop.is_set():
                    return
                while not self._stop.is_set():
                    try:
                        self._pending.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:
            self._error = e
        finally:
            self._producer_done = True

    def ingest(self, max_items: Optional[int] = None) -> int:
        """Drain queued raw items, transform and insert them on this thread.
        Returns the number of items stored. Raises if the producer died."""
        if self._error is not None:
            raise RuntimeError("replay producer failed") from self._error
        done = 0
        while max_items is None or done < max_items:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            fields = [torch.as_tensor(f) for f in self.transform(item)]
            if self._bufs is None:
                self._bufs = [torch.zeros((self.capacity,) + tuple(f.shape), dtype=f.dtype,
                                          device=self.device) for f in fields]
            slot = self._count % self.capacity
            for buf, f in zip(self._bufs, fields):
                buf[slot].copy_(f)
            self._count += 1
            done += 1
        return done

    def ready(self) -> bool:
        return self._count >= self.min_fill or (
            self._producer_done and self._pending.empty()
            and self._count >= self.batch_size)

    def exhausted(self) -> bool:
        """The generator ended before it produced one batch's worth of items."""
        return (self._producer_done and self._pending.empty()
                and self._count < self.batch_size)

    def buffers(self) -> tuple:
        """The ring tensors on the device, one per stored field."""
        return tuple(self._bufs)

    def sample_idx(self, g: int) -> np.ndarray:
        """(g, batch_size) int32 slot indices, without replacement in a row."""
        n = min(self._count, self.capacity)
        idx = np.stack([self._rng.choice(n, size=self.batch_size, replace=False)
                        for _ in range(g)])
        self._drawn += g * self.batch_size
        return idx.astype(np.int32)

    def stats(self) -> dict:
        return {"produced": self._count, "drawn": self._drawn,
                "reuse_factor": self._drawn / max(self._count, 1),
                "buffered": min(self._count, self.capacity)}

    def stop(self):
        self._stop.set()
