"""Activations (reference: modules/basics.py:10-29)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (reference Swish)."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x)


class Swish(nn.Module):
    """Stateless Swish layer; holds a torch Sequential index in the
    reference's layer stacks."""

    def forward(self, x):
        return swish(x)
