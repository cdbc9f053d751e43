"""Data parallelism (counterpart of ``lns_tpu.parallel``): one process per
device under ``torchrun``, the batch split over the ranks and the
parameters replicated, gradients averaged by ``DistributedDataParallel``'s
all-reduce (NCCL on the card, gloo on the CPU); the predict sharded the same
way (``sharded_predict``, ``gather_rows``)."""

from lns_tpu_torch.parallel.ddp import (barrier, broadcast_scalar, gather_rows,  # noqa: F401
                                        init_from_env, is_main, pad_to_multiple, rank,
                                        shard_rows, sharded_predict, stratified_batches,
                                        world_size)
