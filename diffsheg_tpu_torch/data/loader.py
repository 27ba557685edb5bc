"""Host input pipeline: seeded, sharded batches with a prefetch thread.

The port's own copy of ``diffsheg_tpu/data/loader.py`` (numpy only):

  - epoch order = a seeded permutation, rounded up to a multiple of the
    global batch (``drop_last=False``) or cut to whole batches, reseeded
    per epoch by ``set_epoch``;
  - each process takes its contiguous block of every global batch
    (process p gets rows ``[p*local : (p+1)*local]``);
  - a background thread keeps ``prefetch`` batches in flight so the host
    gather overlaps device compute, and is released when the consumer
    stops early.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class ShardedBatchLoader:
    """Iterates seeded, sharded, fixed-size batches over an indexable dataset
    exposing ``batch(indices) -> dict[str, np.ndarray]``."""

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        transform: Optional[Callable[[Dict], Dict]] = None,
    ):
        if global_batch_size % process_count:
            raise ValueError(f"global batch {global_batch_size} does not "
                             f"split over {process_count} processes")
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.transform = transform
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return -(-n // self.global_batch_size)

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.RandomState((self.seed * 100003 + self.epoch)
                                    % (2 ** 31))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        if not self.drop_last:
            pad = (-n) % self.global_batch_size
            if pad:
                order = np.concatenate([order, order[:pad]])
        else:
            order = order[:len(self) * self.global_batch_size]
        return order

    def _local_indices(self, global_rows: np.ndarray) -> np.ndarray:
        b = self.local_batch_size
        return global_rows[self.process_index * b:(self.process_index + 1) * b]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        batches = order.reshape(-1, self.global_batch_size)

        if self.prefetch <= 0:
            for rows in batches:
                yield self._make(rows)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            """A bounded put that notices an abandoned consumer."""
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for rows in batches:
                    if not put(self._make(rows)):
                        return
            finally:
                # the end mark waits for room like a batch: dropped on a
                # full queue (as the JAX loader does), the consumer would
                # wait for it forever
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # consumer stopped early (debug mode, max_batches): release the
            # worker instead of leaking a thread blocked on q.put
            abandoned.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def _make(self, global_rows: np.ndarray) -> Dict[str, np.ndarray]:
        b = self.dataset.batch(self._local_indices(global_rows))
        return self.transform(b) if self.transform else b

