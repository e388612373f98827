"""Batching with background prefetch (host side).

Counterpart of ``collate`` and ``BatchLoader`` in
``deep3dpointclouddenoising_tpu/data/loader.py``: a thread assembles numpy
batches (patch extraction is numpy and scipy, which release the GIL) while
the card computes.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Iterate batches of a dataset exposing ``get(idx)``/``__len__``, in
    index order; the last batch may be smaller."""

    PREFETCH = 2     # batches assembled ahead of the consumer
    NUM_WORKERS = 4  # threads assembling one batch

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _indices(self):
        n = len(self.dataset)
        for s in range(0, n, self.batch_size):
            yield range(s, min(s + self.batch_size, n))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        done = object()
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.NUM_WORKERS) as pool:
                    for idxs in self._indices():
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(self.dataset.get,
                                                    idxs))))
            except BaseException as e:  # re-raised in the consumer
                q.put(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
