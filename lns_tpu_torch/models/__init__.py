"""Composite models: the stage-1 autoencoders, the latent propagators and
the latent dynamics that chains them."""

from lns_tpu_torch.models.autoencoder import (CondEncoder,  # noqa: F401
                                              ConditionalSimpleAutoencoder, SimpleAutoencoder)
from lns_tpu_torch.models.latent_dynamics import LatentDynamics  # noqa: F401
from lns_tpu_torch.models.propagator import (CondDilatedResidualBlock,  # noqa: F401
                                             ConditionalResNet, CondSimpleCNN,
                                             DilatedResidualBlock, SimpleCNN, SimpleMLP,
                                             SimpleResNet, build_propagator)
