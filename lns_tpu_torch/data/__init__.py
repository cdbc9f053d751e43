"""Data pipelines (numpy, channels-last): the NS2d, SW and two-phase (also
conditional) frames for
stage-1 training and latent corpora for stage 2, the KM2D datasets (no
trainer uses them), batch index iteration, the side-stream prefetch
(``prefetch``), the synthetic corpora and the solvers that generate NS2d
and SW corpora with real PDE dynamics (``ns2d_solver``, ``sw_solver``,
run on the card). Copies of
``lns_tpu.data``'s numpy modules for the families the port trains, so the
port imports nothing of the JAX package."""

from lns_tpu_torch.data.km2d import KM2DStage1, KM2DStage2  # noqa: F401
from lns_tpu_torch.data.loader import epoch_batches, pad_batch, to_device  # noqa: F401
from lns_tpu_torch.data.ns2d import NS2DStage1, NS2DStage2  # noqa: F401
from lns_tpu_torch.data.ns2d_solver import (gaussian_random_field,  # noqa: F401
                                            make_ns2d_solver_npz, simulate_ns2d)
from lns_tpu_torch.data.shallow_water import SW2DDataSimple, SWStage1, SWStage2  # noqa: F401
from lns_tpu_torch.data.sw_solver import make_sw_solver_store, simulate_sw  # noqa: F401
from lns_tpu_torch.data.twophase import (ConditionalTankSloshingStage2,  # noqa: F401
                                          SimpleTankSloshingData, TankSloshingStage1,
                                          TankSloshingStage2)
