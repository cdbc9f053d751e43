"""Activations (reference: modules/basics.py:10-29).

In f32 they are torch's own. In bf16 and f16 they round where the JAX
package's ``lns_tpu.ops.activations`` rounds under ``jax.jit`` on the CPU,
as measured against it (``tests/test_torch_port_ops.py``): XLA keeps some
intermediates of a fused elementwise chain in f32 and rounds others, so the
points come from the measurement, not from the HLO.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_LOW = (torch.bfloat16, torch.float16)
_SQRT_HALF = 0.70703125  # 1 / sqrt(2) as a bf16 (and f16) constant, as XLA folds it
_F32_MAX_DENORMAL = 1.1754942e-38  # erfc below f32's smallest normal flushes to 0, as in XLA


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (reference Swish). bf16 / f16: ``x * (1 / (1 +
    exp(-x)))`` with every op rounded to x's dtype, what XLA computes for
    ``x * jax.nn.sigmoid(x)``."""
    if x.dtype in _LOW:
        return x * (1 / (1 + torch.exp(-x)))
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default. bf16 / f16: ``0.5 x
    erfc(-x c)`` with c = bf16(1 / sqrt(2)), the product with c and the
    final products in f32, erfc's result (flushed to 0 below f32's normal
    range) rounded to x's dtype before the last product, and the result
    rounded once; f16 also rounds the product with c."""
    if x.dtype not in _LOW:
        return F.gelu(x)
    xf = x.float()
    arg = xf * -_SQRT_HALF
    if x.dtype == torch.float16:
        arg = arg.to(x.dtype).float()
    e = F.threshold(torch.special.erfc(arg), _F32_MAX_DENORMAL, 0.0).to(x.dtype)
    return (xf * e).mul_(0.5).to(x.dtype)  # x e is exact in f32, and so is the halving


ACTIVATION_REGISTRY = {"relu": torch.relu, "silu": swish, "gelu": gelu, "tanh": torch.tanh,
                       "sigmoid": torch.sigmoid}


def get_activation(name: str):
    """The activation function of a block's ``activation`` name (the JAX
    package's ``ACTIVATION_REGISTRY``; ``silu`` is ``swish``)."""
    if name not in ACTIVATION_REGISTRY:
        raise NotImplementedError(f"Activation {name} not implemented")
    return ACTIVATION_REGISTRY[name]


class Swish(nn.Module):
    """Stateless Swish layer; holds a torch Sequential index in the
    reference's layer stacks."""

    def forward(self, x):
        return swish(x)


class GELU(nn.Module):
    """Stateless exact GELU layer (``gelu``), in place of ``nn.GELU``."""

    def forward(self, x):
        return gelu(x)
