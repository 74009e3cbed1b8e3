"""Automatic batch-size selection (reference ``fce_yolo_tpu/utils/autobatch.py``).

The reference compiles the step at a probe batch and reads XLA's memory
analysis. On the card the port runs one probe call and reads its peak
memory (``torch.cuda.reset_peak_memory_stats``, ``max_memory_allocated``);
the rest is the reference's rule: memory scales linearly in the batch, and
the largest power of two that fits ``fraction`` of the card's memory wins.
"""

from __future__ import annotations

import torch

__all__ = ["autobatch", "device_memory_bytes"]


def device_memory_bytes(device: torch.device | str = "cuda") -> int:
    """The card's total memory (``torch.cuda.mem_get_info``)."""
    return int(torch.cuda.mem_get_info(torch.device(device))[1])


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _measure(fn, args: tuple) -> tuple[int, int] | None:
    """(bytes one call of ``fn(*args)`` needs, the card's bytes): its
    arguments, and its peak allocation above what was held before the call
    (the temporaries and the outputs), as the reference's memory analysis
    counts them. None when the arguments are not on a card."""
    tensors = _tensors(args)
    if not tensors or tensors[0].device.type != "cuda":
        return None
    dev = tensors[0].device
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - held
    return peak + sum(t.nbytes for t in tensors), device_memory_bytes(dev)


def autobatch(
    make_fn,
    example_batch_fn,
    probe_batch: int = 8,
    fraction: float = 0.8,
    max_batch: int = 1024,
) -> int:
    """Pick the largest power-of-two batch fitting ``fraction`` of the
    card's memory.

    Args:
        make_fn: batch_size -> the function to size (closed over the model).
        example_batch_fn: batch_size -> its argument tuple (tensors on the
            device the function runs on).
        probe_batch: the batch of the probe call.

    Returns the chosen batch size; ``probe_batch`` when the arguments are
    not on a card (nothing is measured, as the reference keeps the probe
    size without its memory analysis).
    """
    measured = _measure(make_fn(probe_batch), example_batch_fn(probe_batch))
    if not measured or measured[0] <= 0:
        return probe_batch
    mem, total = measured
    budget = total * fraction
    per_item = mem / probe_batch
    n = int(budget / per_item)
    b = 1
    while b * 2 <= min(n, max_batch):
        b *= 2
    return max(b, 1)
