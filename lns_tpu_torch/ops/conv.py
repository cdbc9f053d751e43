"""Convolutions on NCHW tensors (channels-last memory) with torch-compatible
padding, OIHW weights and the reference's parameter names.

Rounding follows ``lns_tpu.ops.conv``: the product runs in the activation
dtype (f32 accumulation inside the library kernel), is rounded to that
dtype, and the bias, cast to the same dtype, is added after. Parameters are
stored in f32 and cast at use, as flax's ``dtype=`` does. Constructors
make zero parameters: load a state dict, or fill them with
``lns_tpu_torch.ops.initializers.init_weights_`` and an explicit generator.

Circular padding is an explicit ``F.pad(mode="circular")``; zero padding
rides the convolution. Half-periodic padding (``half_periodic_x``: W
wraps, H is zero-padded; ``half_periodic_y`` the other way round) wraps its
periodic axis explicitly, except for a 3x3 stride-1 pad-1 conv, which the
JAX package computes as a zero-padded conv plus the two wrapped boundary
strips (``lns_tpu.ops.conv._wrap_corrections_2d``): the strips are rounded
to the activation dtype and added in it before the bias, so in bf16 the two
boundary columns (rows) round twice. This module computes that function,
at those rounding points. ``upsample_2x`` is a nearest-2x upsample
followed by a 3x3 stride-1 pad-1 conv (the reference's upsample blocks and
decoder tail), run as the JAX package lowers it
(``lns_tpu.ops.conv._up2x_conv``): one input-dilated conv over the small
grid with the box-summed 4x4 kernel, whose taps are summed in the
activation dtype (so rounded in bf16), here a stride-2 transposed conv.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from lns_tpu_torch.ops.padding import HALF_PERIODIC_AXIS, pad_nd

PADDING_MODES = ("zeros", "circular", "half_periodic_x", "half_periodic_y")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


class ConvND(nn.Module):
    """torch.nn.Conv2d equivalent (2 spatial dims).

    padding_mode: 'zeros' | 'circular' | 'half_periodic_x' |
    'half_periodic_y'; padding: int (symmetric) or per-axis (lo, hi)
    pairs."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Union[int, Sequence[int]], stride=1,
                 padding: Union[int, Sequence[Tuple[int, int]]] = 0, dilation=1,
                 padding_mode: str = "zeros", use_bias: bool = True,
                 upsample_2x: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding_mode not in PADDING_MODES:
            raise ValueError(f"unknown padding mode {padding_mode}")
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        if isinstance(padding, int):
            self.pads = [(padding, padding)] * 2
        else:
            self.pads = [tuple(p) for p in padding]
        self.padding_mode = padding_mode
        if upsample_2x and ((kh, kw) != (3, 3) or self.stride != (1, 1)
                            or self.dilation != (1, 1) or self.pads != [(1, 1), (1, 1)]):
            raise ValueError("upsample_2x takes a 3x3 conv with stride 1, dilation 1, pad 1")
        self.upsample_2x = upsample_2x
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _wraps(self) -> Tuple[bool, bool]:
        """Whether the H axis and the W axis wrap."""
        if self.padding_mode in HALF_PERIODIC_AXIS:
            axis = HALF_PERIODIC_AXIS[self.padding_mode]
            return axis == 0, axis == 1
        return (self.padding_mode == "circular",) * 2

    def _up2x(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Nearest-2x upsample + this 3x3 conv as the JAX package's
        input-dilated conv: K4 = K * box2 per axis (taps [K0, K0+K1, K1+K2,
        K2]) summed in dt in its order, then a stride-2 transposed conv with
        the flipped K4, which is the input-dilated conv. Each axis by its
        own mode: a wrapping axis wraps x by one small-grid pixel, a
        zero-padded one pads the dilated input by 2."""
        w = self.weight.to(dt)
        k4 = torch.zeros(w.shape[:2] + (4, 4), dtype=dt, device=w.device)
        for dp in range(2):
            for dq in range(2):
                k4[:, :, dp:dp + 3, dq:dq + 3] += w
        wraps = self._wraps()
        if any(wraps):
            x = pad_nd(x, [(1, 1) if wrap else (0, 0) for wrap in wraps], mode="circular")
        pad = tuple(3 if wrap else 1 for wrap in wraps)
        return F.conv_transpose2d(x.to(dt), k4.flip(2, 3).transpose(0, 1), None, 2, pad)

    def _strips(self) -> bool:
        """Whether this conv is the JAX package's zero-padded conv plus
        wrapped boundary strips: a half-periodic 3x3, stride 1, dilation 1,
        pad 1 conv (``lns_tpu.ops.conv.ConvND``, its ``decompose`` case)."""
        return (self.padding_mode in HALF_PERIODIC_AXIS and tuple(self.weight.shape[2:]) == (3, 3)
                and self.stride == (1, 1) and self.dilation == (1, 1)
                and self.pads == [(1, 1), (1, 1)])

    def _add_wrapped_strips(self, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor):
        """Add what the zero padding left out at the periodic axis's two
        boundary lines of `out` (the conv of x [B, C, H, W] with w, zero pad
        1): the wrapped neighbour line through the kernel's first (last)
        row or column, each a strip conv in dt rounded to dt, added in dt
        (``lns_tpu.ops.conv._wrap_corrections_2d``)."""
        axis = 2 + HALF_PERIODIC_AXIS[self.padding_mode]
        n = x.shape[axis]
        pad = (0, 1) if axis == 2 else (1, 0)  # the other axis stays zero-padded
        lo = F.conv2d(x.narrow(axis, n - 1, 1), w.narrow(axis, 0, 1), None, 1, pad)
        hi = F.conv2d(x.narrow(axis, 0, 1), w.narrow(axis, 2, 1), None, 1, pad)
        out.narrow(axis, 0, 1).add_(lo)
        out.narrow(axis, n - 1, 1).add_(hi)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.product(x)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)[:, None, None]
        return out

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias, in the activation dtype."""
        dt = self.dtype or x.dtype
        if self.upsample_2x:
            out = self._up2x(x, dt)
        elif self._strips() and min(x.shape[2:]) >= 3:
            x, w = x.to(dt), self.weight.to(dt)
            out = self._add_wrapped_strips(x, w, F.conv2d(x, w, None, 1, 1))
        else:
            conv_pad = (0, 0)
            if any(p != (0, 0) for p in self.pads):
                symmetric = all(lo == hi for lo, hi in self.pads)
                if self.padding_mode == "zeros" and symmetric:
                    conv_pad = tuple(lo for lo, _ in self.pads)
                else:
                    x = pad_nd(x, self.pads, mode=self.padding_mode)
            out = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                           conv_pad, self.dilation)
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
