"""Data-parallel training over processes (counterpart of
``lns_tpu.parallel.mesh``).

The JAX package trains on a 1-D ``data`` mesh: the batch is sharded on its
leading axis, the parameters are replicated and XLA averages the gradients.
Here each device is one process (``torchrun``): ``init_from_env`` joins the
process group that torchrun's environment describes, a trainer wraps its
loss module in ``DistributedDataParallel`` (``wrap``), and each rank feeds
its rows of every global batch:

- ``shard_rows``: rank r's contiguous rows of a global batch of indices
  (what ``shard_batch`` gives device r on the mesh);
- ``stratified_batches``: the JAX package's order for a corpus that lives
  on the devices (``device_data``), each rank gathering from its own
  contiguous shard with a permutation of its own per epoch.

With no process group (one process, no torchrun environment) every helper
is the single-device identity and ``wrap`` builds no wrapper.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def init_from_env(device=None, init_method: str = "env://") -> torch.device:
    """The device this process trains on, after joining the process group
    that torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` describe:
    NCCL and ``cuda:LOCAL_RANK`` for a CUDA `device` (the card when None),
    gloo for the CPU. Without ``WORLD_SIZE`` in the environment it joins
    nothing and returns `device`. `init_method` is the rendezvous
    (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` by default; a
    ``file://`` path works without a port)."""
    dev = torch.device("cuda" if device is None else device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: no CUDA device; pass device=\"cpu\" (--device cpu) "
                               "to train on the CPU with gloo")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank_, world_size=world)
    return dev


def shutdown() -> None:
    """Leave the process group, when there is one."""
    if distributed():
        dist.destroy_process_group()


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if not distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


@contextlib.contextmanager
def main_first():
    """Rank 0 runs the block before the other ranks do (it makes the run
    directory and the datasets' statistics files that they then read)."""
    if not is_main():
        barrier()
    yield
    if is_main():
        barrier()


def broadcast_scalar(value, src: int = 0):
    """`value` as rank `src` has it, on every rank."""
    if not distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of a tensor over the ranks (gloo has no AVG: a sum, then a
    division by the world size, exact at one rank); not fetched."""
    if not distributed():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / dist.get_world_size()


def wrap(module: nn.Module, device: torch.device) -> nn.Module:
    """`module` in ``DistributedDataParallel`` under a process group, else
    `module` itself. Its forward must compute the loss: DDP arms its
    gradient all-reduce in ``forward``. Buffers are not broadcast at each
    forward (the models' buffers are constants), and every parameter that
    requires grad must take part in the loss (``find_unused_parameters``
    off); the bucketed all-reduce runs in the gradients' dtype (f32)."""
    if not distributed():
        return module
    return nn.parallel.DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def shard_rows(idx, rank_: int, world: int):
    """Rank `rank_`'s contiguous rows of the global batch `idx` (an index
    array, or a tensor drawn for the global batch such as the stage-2 input
    noise): what ``shard_batch`` puts on device `rank_` of a `world`-device
    mesh. The global batch must divide by the world size, as the mesh needs."""
    if len(idx) % world:
        raise ValueError(f"a global batch of {len(idx)} does not divide over {world} ranks; "
                         "make batch_size a multiple of the world size")
    per = len(idx) // world
    return idx[rank_ * per: (rank_ + 1) * per]


def corpus_shard(n: int, rank_: int, world: int) -> np.ndarray:
    """The rows of rank `rank_`'s shard of an `n`-sample corpus that lives
    on the devices: the corpus trimmed to ``n - n % world``, cut into
    `world` contiguous shards."""
    shard_len = n // world
    return np.arange(rank_ * shard_len, (rank_ + 1) * shard_len)


def stratified_batches(rng: np.random.Generator, n: int, batch: int,
                       world: int) -> Iterator[np.ndarray]:
    """One epoch of the JAX package's ``device_data`` order on a `world`-
    device mesh (``lns_tpu/train/stage2.py:243-252,266-276``): the corpus
    trimmed to ``n - n % world`` and cut into contiguous shards, one
    ``rng.permutation(shard_len)`` per rank, stacked; step s takes columns
    ``[s * b_per, (s + 1) * b_per)``. Yields [world, batch // world] arrays
    of indices local to each rank's shard (``corpus_shard``). At one rank
    this is ``epoch_batches(n, batch, rng, drop_last=True)``."""
    if batch % world:
        raise ValueError(f"a global batch of {batch} does not divide over {world} ranks; "
                         "make batch_size a multiple of the world size")
    b_per, shard_len = batch // world, n // world
    perms = np.stack([rng.permutation(shard_len) for _ in range(world)])
    return (perms[:, s * b_per: (s + 1) * b_per] for s in range(shard_len // b_per))


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis of an array (or of each array of a tuple or
    list) to a multiple of `multiple` by repeating its last row; returns
    (padded, n_valid) (``lns_tpu/parallel/mesh.py:62-75``)."""
    def pad(x):
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)

    if isinstance(batch, (tuple, list)):
        return type(batch)(pad(x) for x in batch), batch[0].shape[0]
    return pad(batch), batch.shape[0]

