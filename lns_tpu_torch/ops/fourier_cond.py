"""Conditional spectral convolution (reference: modules/fourier_cond.py,
from pdearena, MIT), the counterpart of ``lns_tpu.ops.fourier_cond``.

``FreqLinear`` maps a conditioning vector to complex per-mode scalings of
the two row blocks; ``CondSpectralConv2d`` scales the retained modes by
them before the weight contraction; ``CondFourierBasicBlock`` adds a 1x1
bypass and a linear projection of the vector, then GELU and the residual.
The vector [B, C] stays f32, so a bf16 block's sum and everything after it
promote to f32, as in the JAX block.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lns_tpu_torch.ops.activations import gelu
from lns_tpu_torch.ops.conv import Conv1x1, Dense
from lns_tpu_torch.ops.spectral import _spectral_weight, as_complex, spectral_conv2d_fft


class FreqLinear(nn.Module):
    """cond [B, C] -> complex scalings [B, m1, m2, 2] (the last axis the
    two row blocks): ``cond @ weights + bias``, [C, 4 m1 m2] and
    [1, 4 m1 m2] as the reference stores them, read as (m1, m2, bank,
    re / im)."""

    def __init__(self, in_channel: int, modes1: int, modes2: int):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.weights = nn.Parameter(torch.zeros(in_channel, 4 * modes1 * modes2))
        self.bias = nn.Parameter(torch.zeros(1, 4 * modes1 * modes2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.weights.to(x.dtype) + self.bias.to(x.dtype)
        h = h.float().reshape(x.shape[0], self.modes1, self.modes2, 2, 2)
        return torch.complex(h[..., 0], h[..., 1])


class CondSpectralConv2d(nn.Module):
    """``SpectralConv2d`` whose retained modes are scaled by ``cond_emb``'s
    per-mode scalings (``FreqLinear`` of the vector) before the contraction;
    x [B, C, H, W], the vector [B, cond_channels]."""

    def __init__(self, in_channels: int, out_channels: int, cond_channels: int, modes1: int,
                 modes2: int):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.weights1 = _spectral_weight(in_channels, out_channels, modes1, modes2)
        self.weights2 = _spectral_weight(in_channels, out_channels, modes1, modes2)
        self.cond_emb = FreqLinear(cond_channels, modes1, modes2)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        e = self.cond_emb(emb)
        y = spectral_conv2d_fft(x.movedim(1, -1), as_complex(self.weights1),
                                as_complex(self.weights2), self.modes1, self.modes2,
                                e[..., 0], e[..., 1])
        return y.to(x.dtype).movedim(-1, 1)


class CondFourierBasicBlock(nn.Module):
    """gelu(cond spectral conv(x, v) + 1x1 conv(x) + Dense(v)), plus x when
    ``residual``; v [B, in_planes] the conditioning vector. 2D only."""

    def __init__(self, in_planes: int, planes: int, modes: Sequence[int], residual: bool = True):
        super().__init__()
        if len(modes) != 2:
            raise ValueError("CondFourierBasicBlock is 2D: two modes")
        self.residual = residual
        self.fourier = CondSpectralConv2d(in_planes, planes, in_planes, *modes)
        self.conv = Conv1x1(in_planes, planes)
        self.cond_emb = Dense(in_planes, planes)

    def forward(self, x: torch.Tensor, cond_emb: torch.Tensor) -> torch.Tensor:
        e = self.cond_emb(cond_emb)[:, :, None, None]
        out = gelu(self.fourier(x, cond_emb) + self.conv(x) + e)
        return x + out if self.residual else out
