"""Residual and resampling blocks (reference: modules/basics.py:224-328 and
modules/autoencoder2d_half_periodic.py:55-103), on NCHW tensors, with the
reference's checkpoint names."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lns_tpu_torch.ops.activations import Swish
from lns_tpu_torch.ops.conv import Conv1x1, ConvND
from lns_tpu_torch.ops.norms import GroupNormWrapper
from lns_tpu_torch.ops.padding import pad_nd


class ResidualBlock(nn.Module):
    """Pre-norm residual block: GN(32)+swish -> conv3 -> GN(32)+swish ->
    conv3, with a 1x1 ``channel_up`` shortcut when channels change
    (reference: modules/basics.py:224-276). Each GN+swish pair is one call
    of the fused GroupNorm kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 padding_mode: str = "zeros", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block = nn.Sequential(
            GroupNormWrapper(in_channels),
            Swish(),
            ConvND(in_channels, out_channels, 3, padding=1,
                   padding_mode=padding_mode, dtype=dtype),
            GroupNormWrapper(out_channels),
            Swish(),
            ConvND(out_channels, out_channels, 3, padding=1,
                   padding_mode=padding_mode, dtype=dtype),
        )
        self.channel_up = (Conv1x1(in_channels, out_channels, dtype=dtype)
                           if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block[0](x, apply_swish=True)
        h = self.block[2](h)
        h = self.block[3](h, apply_swish=True)
        h = self.block[5](h)
        if self.channel_up is not None:
            x = self.channel_up(x)
        return x + h


class UpSampleBlock(nn.Module):
    """Nearest x2 + conv3 (reference: modules/basics.py:279-299)."""

    def __init__(self, channels: int, padding_mode: str = "zeros",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_layer = ConvND(channels, channels, 3, padding=1,
                                 padding_mode=padding_mode, upsample_2x=True,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_layer(x)


class DownSampleBlock(nn.Module):
    """Stride-2 conv3 with the reference's padding arithmetic
    (modules/basics.py:302-328): circular mode pads (1, 1) per axis, zeros
    mode pads (0, 1)."""

    def __init__(self, channels: int, padding_mode: str = "zeros",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding_mode = padding_mode
        self.conv_layer = ConvND(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding_mode == "circular":
            x = pad_nd(x, [(1, 1)] * 2, mode="circular")
        else:
            x = pad_nd(x, [(0, 1)] * 2, mode="zeros")
        return self.conv_layer(x)


class NormAct(nn.Module):
    """GN(32) + swish as the half-periodic variant names it
    (``norm_act.0.gn``); one call of the fused GroupNorm kernel."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm_act = nn.Sequential(GroupNormWrapper(channels), Swish())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_act[0](x, apply_swish=True)


class HalfPeriodicResBlock2d(nn.Module):
    """Residual block of half-periodic convs: GN(32)+swish -> conv3 ->
    GN(32)+swish -> conv3, with a 1x1 ``channel_up`` shortcut when channels
    change (reference: modules/autoencoder2d_half_periodic.py:77-103)."""

    def __init__(self, in_channels: int, out_channels: int, periodic_direction: str = "x",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pm = f"half_periodic_{periodic_direction}"
        self.norm_act1 = NormAct(in_channels)
        self.conv1 = ConvND(in_channels, out_channels, 3, padding=1, padding_mode=pm, dtype=dtype)
        self.norm_act2 = NormAct(out_channels)
        self.conv2 = ConvND(out_channels, out_channels, 3, padding=1, padding_mode=pm, dtype=dtype)
        self.channel_up = (Conv1x1(in_channels, out_channels, dtype=dtype)
                           if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm_act2(self.conv1(self.norm_act1(x))))
        if self.channel_up is not None:
            x = self.channel_up(x)
        return h + x


class DownSampleBlock2dHalfPeriodic(nn.Module):
    """Half-periodic stride-2 conv3, pad 1 (reference:
    modules/autoencoder2d_half_periodic.py:68-74)."""

    def __init__(self, channels: int, periodic_direction: str = "x",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_layer = ConvND(channels, channels, 3, stride=2, padding=1,
                                 padding_mode=f"half_periodic_{periodic_direction}", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_layer(x)


class UpSampleBlock2dHalfPeriodic(nn.Module):
    """Half-periodic nearest x2 + conv3 (reference:
    modules/autoencoder2d_half_periodic.py:55-65)."""

    def __init__(self, channels: int, periodic_direction: str = "x",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_layer = ConvND(channels, channels, 3, padding=1,
                                 padding_mode=f"half_periodic_{periodic_direction}",
                                 upsample_2x=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_layer(x)
