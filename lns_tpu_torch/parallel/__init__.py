"""Data parallelism (counterpart of ``lns_tpu.parallel``): one process per
device under ``torchrun``, the batch split over the ranks and the
parameters replicated, gradients averaged by ``DistributedDataParallel``'s
all-reduce (NCCL on the card, gloo on the CPU)."""

from lns_tpu_torch.parallel.ddp import (barrier, broadcast_scalar, init_from_env,  # noqa: F401
                                        is_main, pad_to_multiple, rank, shard_rows,
                                        stratified_batches, world_size)
