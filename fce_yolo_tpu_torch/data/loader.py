"""Threaded prefetching loader (reference ``fce_yolo_tpu/data/loader.py:25-106``).

A thread pool reads the items (``YOLODataset.get``) a few batches ahead of
the consumer; no worker processes. Every batch has the same shape:

- val: the dataset in order; the last batch is padded by repeating its last
  image and carries ``n_valid``, the count of real images in it;
- train: a shuffle by ``default_rng(seed + epoch)``, the last partial batch
  dropped. Item j of the epoch draws its augment from its own generator,
  ``default_rng([dataset.epoch_seed, j])``, so the batches do not depend on
  the thread count or timing. (The reference's threads share the dataset's
  one generator, so its augment stream depends on thread timing once
  ``workers > 1``.)
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fce_yolo_tpu_torch.data.dataset import YOLODataset, collate

__all__ = ["DataLoader"]

PREFETCH = 3  # batches read ahead of the consumer


class DataLoader:
    """Fixed-shape batches of a ``YOLODataset`` (module docstring).

    Args:
        dataset: the dataset; its mode picks the train or val behaviour.
        batch_size: images a batch.
        workers: threads reading items.
        max_labels: label slots an image in a batch.
        seed: the train shuffle's seed (plus the epoch).
    """

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, workers: int = 8, max_labels: int = 128,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(1, workers)
        self.max_labels = max_labels
        self.seed = seed
        self.epoch = 0
        self.train = dataset.mode == "train"

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def set_epoch(self, epoch: int, **kw) -> None:
        """Epoch for the shuffle; ``kw`` go to ``dataset.set_epoch`` (mosaic closing)."""
        self.epoch = epoch
        self.dataset.set_epoch(epoch, **kw)

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.train:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def _item(self, j: int, i: int) -> dict:
        """The epoch's item j, which is image i."""
        if self.train:
            return self.dataset.get(i, np.random.default_rng([self.dataset.epoch_seed, j]))
        return self.dataset.get(i)

    def __iter__(self):
        order, bs = self._order(), self.batch_size
        todo = iter(range(len(self)))
        with ThreadPoolExecutor(self.workers) as pool:
            ahead: deque[list] = deque()

            def submit() -> None:
                b = next(todo, None)
                if b is not None:
                    js = range(b * bs, min((b + 1) * bs, len(order)))
                    ahead.append([pool.submit(self._item, j, int(order[j])) for j in js])

            for _ in range(PREFETCH):
                submit()
            try:
                while ahead:
                    futures = ahead.popleft()
                    submit()
                    samples = [f.result() for f in futures]
                    n_valid = len(samples)
                    samples += [samples[-1]] * (bs - n_valid)  # pad the val tail to the fixed shape
                    out = collate(samples, self.max_labels, obb=self.dataset.task == "obb")
                    out["n_valid"] = n_valid
                    yield out
            finally:  # the consumer stopped early: drop what was read ahead
                for futures in ahead:
                    for f in futures:
                        f.cancel()
