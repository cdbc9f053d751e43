"""Convolutions on NCHW tensors (channels-last memory) with torch-compatible
padding, OIHW weights and the reference's parameter names.

Rounding follows ``lns_tpu.ops.conv``: the product runs in the activation
dtype (f32 accumulation inside the library kernel), is rounded to that
dtype, and the bias, cast to the same dtype, is added after. Parameters are
stored in f32 and cast at use, as flax's ``dtype=`` does. Constructors
make zero parameters: load a state dict, or fill them with
``lns_tpu_torch.ops.initializers.init_weights_`` and an explicit generator.

Circular padding is an explicit ``F.pad(mode="circular")``; zero padding
rides the convolution. ``upsample_2x`` is a nearest-2x upsample followed by
the conv.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from lns_tpu_torch.ops.padding import pad_nd


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


class ConvND(nn.Module):
    """torch.nn.Conv2d equivalent (2 spatial dims).

    padding_mode: 'zeros' | 'circular'; padding: int (symmetric) or per-axis
    (lo, hi) pairs."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Union[int, Sequence[int]], stride=1,
                 padding: Union[int, Sequence[Tuple[int, int]]] = 0, dilation=1,
                 padding_mode: str = "zeros", use_bias: bool = True,
                 upsample_2x: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding_mode not in ("zeros", "circular"):
            raise ValueError(f"unknown padding mode {padding_mode}")
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        if isinstance(padding, int):
            self.pads = [(padding, padding)] * 2
        else:
            self.pads = [tuple(p) for p in padding]
        self.padding_mode = padding_mode
        self.upsample_2x = upsample_2x
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.upsample_2x:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        conv_pad = (0, 0)
        if any(p != (0, 0) for p in self.pads):
            symmetric = all(lo == hi for lo, hi in self.pads)
            if self.padding_mode == "zeros" and symmetric:
                conv_pad = tuple(lo for lo, _ in self.pads)
            else:
                x = pad_nd(x, self.pads, mode=self.padding_mode)
        out = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                       conv_pad, self.dilation)
        if self.bias is not None:
            out = out + self.bias.to(dt)[:, None, None]
        return out


class Conv1x1(nn.Module):
    """Pointwise conv as a channel matmul; weight [O, I, 1, 1] like the
    reference's nn.Conv2d(kernel_size=1)."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward_last(self, x: torch.Tensor) -> torch.Tensor:
        """The same map on a channels-last tensor [..., C]."""
        dt = self.dtype or x.dtype
        out = F.linear(x.to(dt), self.weight[:, :, 0, 0].to(dt))
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_last(x.movedim(1, -1)).movedim(-1, 1)


class Dense(nn.Module):
    """torch.nn.Linear equivalent on the last dim."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        out = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out
