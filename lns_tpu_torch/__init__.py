"""LNS in PyTorch for NVIDIA Hopper: the port of ``lns_tpu`` (JAX/TPU).

The Latent Neural PDE Solver: a conv autoencoder from a full-order 2D field
to a coarse latent grid, and a latent propagator rolled out autoregressively.
This package runs the inference rollout (encode -> N propagator steps ->
decode, chunked or whole) of the NS2d, SW (shallow-water, half-periodic),
two-phase (tank sloshing, zero-padded, non-square) and conditional
two-phase (its propagator conditioned on each case's driving frequency
through FiLM) families with
hand-written kernels for its hot spots (``lns_tpu_torch.kernels``), and
trains both stages of each: the autoencoder (stage 1,
``lns_tpu_torch.train.stage1``) and the propagator (stage 2,
``lns_tpu_torch.train.stage2``, rollout BPTT against a frozen autoencoder),
on one device or data-parallel under ``torchrun``
(``lns_tpu_torch.parallel``). ``lns_tpu_torch.cli`` holds the training,
evaluate and convert entry points (flax msgpack read and written without
flax). Public functions keep the JAX package's NHWC layout, so the two
packages are tested against each other directly.

Importing this package imports torch and numpy only.
"""

__version__ = "0.1.0"

from lns_tpu_torch.config import (Config, load_config, ns2d_config, sw_config,  # noqa: F401
                                  twophase_conditional_config, twophase_config)
