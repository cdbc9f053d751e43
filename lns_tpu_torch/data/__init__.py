"""Data pipelines (numpy, channels-last): the NS2d latent corpus for stage-2
training, batch index iteration and the synthetic NS2d corpus. Copies of
``lns_tpu.data``'s numpy modules for the families the port trains, so the
port imports nothing of the JAX package."""

from lns_tpu_torch.data.loader import epoch_batches, pad_batch, to_device  # noqa: F401
from lns_tpu_torch.data.ns2d import NS2DStage2  # noqa: F401
