"""LNS in PyTorch for NVIDIA Hopper: the port of ``lns_tpu`` (JAX/TPU).

The Latent Neural PDE Solver: a conv autoencoder from a full-order 2D field
to a coarse latent grid, and a latent propagator rolled out autoregressively.
This package runs the NS2d inference rollout (encode -> N propagator steps
-> chunked decode) with hand-written kernels for its hot spots
(``lns_tpu_torch.kernels``), and trains both NS2d stages: the autoencoder
(stage 1, ``lns_tpu_torch.train.stage1``) and the propagator (stage 2,
``lns_tpu_torch.train.stage2``, rollout BPTT against a frozen autoencoder).
Public functions keep the JAX package's NHWC layout, so the two packages
are tested against each other directly.

Importing this package imports torch and numpy only.
"""

__version__ = "0.1.0"

from lns_tpu_torch.config import Config, load_config, ns2d_config  # noqa: F401
