"""Host-to-device input prefetch on a side CUDA stream (counterpart of
``lns_tpu.data.prefetch``).

Each host batch (a tuple of numpy arrays) is copied from pinned memory on
a side stream while the current stream runs the step before it, `size`
batches in flight. The consumer's stream waits for the side stream before
it reads a batch, and each tensor is recorded as used on the consumer's
stream: the caching allocator otherwise hands a freed batch's memory to
the side stream's next copy while a queued step still reads it. On the CPU
the batches pass through as tensors.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


def prefetch_to_device(batches: Iterable[Tuple[np.ndarray, ...]], device,
                       size: int = 2) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield each batch of `batches` as a tuple of tensors on `device`,
    keeping up to `size` copies in flight ahead of the consumer."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()
    it = iter(batches)

    def enqueue():
        batch = next(it, None)
        if batch is None:
            return
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in batch]
        with torch.cuda.stream(side):
            queue.append(tuple(t.to(device, non_blocking=True) for t in host))

    for _ in range(size):
        enqueue()
    while queue:
        current = torch.cuda.current_stream(device)
        current.wait_stream(side)
        batch = queue.popleft()
        for t in batch:
            t.record_stream(current)
        enqueue()
        yield batch
