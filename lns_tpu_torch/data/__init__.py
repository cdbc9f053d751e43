"""Data pipelines (numpy, channels-last): the NS2d, SW and two-phase (also
conditional) frames for
stage-1 training and latent corpora for stage 2, the KM2D datasets (no
trainer uses them), batch index iteration, the side-stream prefetch
(``prefetch``) and the synthetic corpora. Copies of
``lns_tpu.data``'s numpy modules for the families the port trains, so the
port imports nothing of the JAX package."""

from lns_tpu_torch.data.km2d import KM2DStage1, KM2DStage2  # noqa: F401
from lns_tpu_torch.data.loader import epoch_batches, pad_batch, to_device  # noqa: F401
from lns_tpu_torch.data.ns2d import NS2DStage1, NS2DStage2  # noqa: F401
from lns_tpu_torch.data.shallow_water import SW2DDataSimple, SWStage1, SWStage2  # noqa: F401
from lns_tpu_torch.data.twophase import (ConditionalTankSloshingStage2,  # noqa: F401
                                          SimpleTankSloshingData, TankSloshingStage1,
                                          TankSloshingStage2)
