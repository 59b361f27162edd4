"""Host-side batch prefetching: a background thread assembles the next
(batch, targets) pairs while the device runs the current step.

Counterpart of ``adanerf_tpu/data/prefetch.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class BatchPrefetcher:
    """A producer thread building batches ahead of consumption."""

    def __init__(self, make_batch: Callable[[np.ndarray], tuple],
                 image_index_iter: Iterator[np.ndarray], depth: int = 2):
        self._make_batch = make_batch
        self._indices = image_index_iter
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for idx in self._indices:
                if self._stop.is_set():
                    return
                self._q.put(self._make_batch(idx))
        except Exception as e:  # handed to the consumer, raised there
            self._error = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and wait for it to exit."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()


def epoch_image_indices(n_images: int, batch_images: int, n_epochs: int,
                        seed: int = 0) -> Iterator[np.ndarray]:
    """Shuffled image-index batches, reshuffling each pass."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_images)
    cursor = 0
    for _ in range(n_epochs):
        if cursor + batch_images > n_images:
            perm = rng.permutation(n_images)
            cursor = 0
        yield perm[cursor:cursor + batch_images]
        cursor += batch_images

