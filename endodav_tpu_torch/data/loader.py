"""Batching loader with a deterministic multi-thread prefetch pool.

Numpy copy of `endodav_tpu/data/loader.py`: `num_workers` threads decode
and collate batches while the card runs the current step, and a
sequencer emits them in order, so batch order and sampling are the same
for any worker count (the datasets draw per-item rngs).  With ``shard``
(rank, ranks) a data-parallel rank loads only its slice of each global
batch: the shuffle and every item's draws are the single process's, so a
data=N step sees the data=1 step's batch.
"""

from __future__ import annotations

import threading

import numpy as np

from endodav_tpu_torch.data.readers import readlines

__all__ = ["Loader", "readlines"]


def _collate(items: list[dict]) -> dict:
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class Loader:
    """Datasets exposing an ``epoch`` attribute get it bumped every epoch so
    per-item rngs resample across epochs."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 314, prefetch: int = 2,
                 num_workers: int = 1, shard: tuple[int, int] = (0, 1)):
        rank, ranks = shard
        if batch_size % ranks:
            raise ValueError(f"the batch of {batch_size} is not divisible by the data axis "
                             f"of {ranks}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = (rank, ranks)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self._epoch
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)
                   if not (self.drop_last and i + self.batch_size > len(order))]
        rank, ranks = self.shard
        if ranks > 1:  # this rank's slice of each global batch
            batches = [b[rank * len(b) // ranks:(rank + 1) * len(b) // ranks] for b in batches]
        if not batches:
            return

        stop = threading.Event()
        n_workers = min(self.num_workers, len(batches))
        # bounded output buffer: workers stall once prefetch batches wait
        results: dict[int, dict] = {}
        ready = threading.Condition(threading.Lock())
        next_job = [0]
        max_pending = self.prefetch + n_workers

        def worker():
            while not stop.is_set():
                with ready:
                    while len(results) >= max_pending and not stop.is_set():
                        ready.wait(0.1)
                    job = next_job[0]
                    if job >= len(batches):
                        return
                    next_job[0] = job + 1
                try:
                    batch = _collate([self.dataset[int(i)] for i in batches[job]])
                except Exception as e:  # handed to the consumer, which raises it
                    batch = e
                with ready:
                    results[job] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for j in range(len(batches)):
                with ready:
                    while j not in results:
                        ready.wait()
                    batch = results.pop(j)
                    ready.notify_all()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            with ready:
                ready.notify_all()
