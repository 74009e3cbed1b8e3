"""Threaded prefetching val loader (reference ``fce_yolo_tpu/data/loader.py:25-106``, val mode).

A thread pool reads and letterboxes the images (``YOLODataset.__getitem__``)
a few batches ahead of the consumer; no worker processes. Every batch has
the same shape: the last one is padded by repeating its last image and
carries ``n_valid``, the count of real images in it.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

from fce_yolo_tpu_torch.data.dataset import YOLODataset, collate

__all__ = ["DataLoader"]

PREFETCH = 3  # batches read ahead of the consumer


class DataLoader:
    """Fixed-shape batches of a val dataset, in order.

    Args:
        dataset: the val ``YOLODataset``.
        batch_size: images a batch.
        workers: threads reading images.
    """

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(1, workers)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n, bs = len(self.dataset), self.batch_size
        todo = iter(range(0, n, bs))
        with ThreadPoolExecutor(self.workers) as pool:
            ahead: deque[list] = deque()

            def submit() -> None:
                start = next(todo, None)
                if start is not None:
                    ahead.append([pool.submit(self.dataset.__getitem__, i) for i in range(start, min(start + bs, n))])

            for _ in range(PREFETCH):
                submit()
            try:
                while ahead:
                    futures = ahead.popleft()
                    submit()
                    samples = [f.result() for f in futures]
                    n_valid = len(samples)
                    samples += [samples[-1]] * (bs - n_valid)  # pad the tail batch to the fixed shape
                    out = collate(samples)
                    out["n_valid"] = n_valid
                    yield out
            finally:  # the consumer stopped early: drop what was read ahead
                for futures in ahead:
                    for f in futures:
                        f.cancel()
