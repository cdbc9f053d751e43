"""Weight initialisation matching PyTorch layer defaults, from an explicit
generator (counterpart of ``lns_tpu.ops.initializers``).

Conv and linear weights and biases: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), what
torch's kaiming_uniform(a=sqrt(5)) default reduces to. Norm scales 1, shifts
0. Self-attention projections and the learnable positional embedding:
N(0, 0.02), biases 0 (reference: modules/basics.py:358-369). A layer marked
by ``zero_init`` (the conditional propagator's gates, the reference's
``zero_module``) keeps its weights and biases at zero. The values
differ from the JAX package's for the same seed; tests that compare the two
packages load the JAX parameters instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lns_tpu_torch.ops.attention import SABlock
from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
from lns_tpu_torch.ops.norms import GroupNorm, LayerNorm


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=g, dtype=torch.float32) * (2 * bound) - bound)


def _normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=g, dtype=torch.float32) * std)


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
    for m in module.modules():
        if isinstance(m, SABlock):
            for lin in (m.to_q, m.to_k, m.to_v, m.proj_out):
                _normal_(lin.weight, 0.02, generator)
                if lin.bias is not None:
                    lin.bias.zero_()
            if m.pe is not None:
                _normal_(m.pe, 0.02, generator)
    return module
