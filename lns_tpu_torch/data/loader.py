"""Batch index iteration (copy of ``lns_tpu.data.loader``), the
host-to-device copy of a batch and the datasets' denormalising affine."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                  drop_last: bool = False) -> Iterator[np.ndarray]:
    """Yield index arrays for one epoch (torch DataLoader semantics)."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, stop, batch_size):
        yield idx[i: i + batch_size]


def pad_batch(batch: np.ndarray, batch_size: int):
    """Pad a trailing partial batch to `batch_size` (repeat the last
    element); returns (padded, valid_count)."""
    valid = batch.shape[0]
    if valid == batch_size:
        return batch, valid
    pad = np.repeat(batch[-1:], batch_size - valid, axis=0)
    return np.concatenate([batch, pad], axis=0), valid


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on `device`. To a CUDA device it is copied
    from pinned memory without waiting (a pageable copy would wait for the
    card to finish its queued work)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def scale_shift(x, scale, shift):
    """x * scale + shift, numpy arrays and tensors alike; a tensor's scalars
    in its dtype, as JAX takes a Python scalar (weakly typed: for a bf16
    array the scale is rounded to bf16, where torch would keep it in f32)."""
    if isinstance(x, torch.Tensor):
        scale, shift = (torch.tensor(float(v), dtype=x.dtype, device=x.device)
                        for v in (scale, shift))
    else:
        scale, shift = float(scale), float(shift)
    return x * scale + shift
