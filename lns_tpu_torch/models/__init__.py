"""Composite models: the stage-1 autoencoder, the latent propagator and
the latent dynamics that chains them."""

from lns_tpu_torch.models.autoencoder import SimpleAutoencoder  # noqa: F401
from lns_tpu_torch.models.latent_dynamics import LatentDynamics  # noqa: F401
from lns_tpu_torch.models.propagator import (CondSimpleCNN, SimpleCNN,  # noqa: F401
                                             build_propagator)
