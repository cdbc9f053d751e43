"""Weight initialisation matching PyTorch layer defaults, from an explicit
generator (counterpart of ``lns_tpu.ops.initializers``).

Conv and linear weights and biases: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), what
torch's kaiming_uniform(a=sqrt(5)) default reduces to. Norm scales 1, shifts
0. Self-attention projections (``SABlock``, ``LABlock``) and the learnable
positional embedding: N(0, 0.02), biases 0 (reference:
modules/basics.py:358-369). Spectral weights: U(0, 1 / (in out))
(``uniform_scale_init``, modules/basics.py:118-124); ``FreqLinear``'s
``1 / (in + 4 m1 m2) N(0, 1)``, its bias 0 (fourier_cond.py:16-29); a
SIREN layer's weight and bias ``siren_init`` (embedding.py:48-55), a
``SirenNet``'s last layer N(0, 0.02) with bias 0; an ``EmbeddingWrapper``
table N(0, 1). A layer marked
by ``zero_init`` (the conditional propagator's gates, the reference's
``zero_module``) keeps its weights and biases at zero. The values
differ from the JAX package's for the same seed; tests that compare the two
packages load the JAX parameters instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lns_tpu_torch.ops.attention import LABlock, SABlock
from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
from lns_tpu_torch.ops.embedding import EmbeddingWrapper, Siren, SirenNet
from lns_tpu_torch.ops.fourier_cond import CondSpectralConv2d, FreqLinear
from lns_tpu_torch.ops.norms import GroupNorm, LayerNorm
from lns_tpu_torch.ops.spectral import SpectralConv1d, SpectralConv2d, SpectralConv3d


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=g, dtype=torch.float32) * (2 * bound) - bound)


def _normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=g, dtype=torch.float32) * std)


def uniform_scale_init(t: torch.Tensor, scale: float, g: torch.Generator) -> None:
    """U(0, scale) in place: the reference's spectral-conv weights."""
    t.copy_(torch.rand(t.shape, generator=g, dtype=torch.float32) * scale)


def siren_bound(fan_in: int, w0: float, c: float = 6.0, is_first: bool = False) -> float:
    """A SIREN layer's U(-b, b) bound: 1 / fan_in for the first layer, else
    sqrt(c / fan_in) / w0."""
    return (1.0 / fan_in) if is_first else math.sqrt(c / fan_in) / w0


def zero_init(module: nn.Module) -> nn.Module:
    """Mark `module` as a zero-initialised gate (the reference's
    ``zero_module``, ``lns_tpu.ops.conditioning.zeros_init_module``):
    ``init_weights_`` sets its parameters to zero. Returns `module`."""
    module.zero_init = True
    return module


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `module` in place; returns `module`. The
    generator lives on the CPU, so the values do not depend on the device."""
    for m in module.modules():
        if getattr(m, "zero_init", False):
            for p in m.parameters(recurse=False):
                p.zero_()
        elif isinstance(m, (ConvND, Conv1x1, Dense)):
            fan_in = math.prod(m.weight.shape[1:])
            bound = 1.0 / math.sqrt(fan_in)
            _uniform_(m.weight, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FreqLinear):
            _normal_(m.weights, 1.0 / (m.weights.shape[0] + m.weights.shape[1]), generator)
            m.bias.zero_()
        elif isinstance(m, Siren):
            bound = siren_bound(m.weight.shape[1], m.w0, m.c, m.is_first)
            _uniform_(m.weight, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, EmbeddingWrapper):
            for table in m.tables():
                _normal_(table, 1.0, generator)
        elif isinstance(m, (SpectralConv1d, SpectralConv2d, SpectralConv3d, CondSpectralConv2d)):
            for name, p in m.named_parameters(recurse=False):  # the banks [I, O, ..., 2]
                if name.startswith("weights"):
                    uniform_scale_init(p, 1.0 / (p.shape[0] * p.shape[1]), generator)
    for m in module.modules():
        if isinstance(m, SirenNet):
            _normal_(m.last_layer.weight, 0.02, generator)
            m.last_layer.bias.zero_()
        if isinstance(m, (SABlock, LABlock)):
            for lin in (m.to_q, m.to_k, m.to_v, m.proj_out):
                _normal_(lin.weight, 0.02, generator)
                if lin.bias is not None:
                    lin.bias.zero_()
            if m.pe is not None:
                _normal_(m.pe, 0.02, generator)
    return module
