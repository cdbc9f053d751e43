"""Normalization layers on NCHW tensors (channels-last memory).

Torch semantics, as ``lns_tpu.ops.norms``:
  * GroupNorm(32, eps=1e-6) wrapper (reference: modules/basics.py:18-24),
    raw GroupNorm(8, eps=1e-5) and GroupNorm(1) — all through the fused
    GroupNorm(+swish) kernel (``kernels.group_norm``)
  * LayerNorm over the last dim, eps=1e-5, statistics in f32
  * InstanceNorm2d: per-sample per-channel over spatial, no affine, eps=1e-5
"""

from __future__ import annotations

import torch
from torch import nn

from lns_tpu_torch.kernels.group_norm import fused_group_norm_swish, group_norm_swish_plain


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm with an optional fused swish; f32 parameters and
    statistics, output in the input's dtype. ``use_kernel=False`` runs the
    kernel's plain version instead, on any device."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.use_kernel = True

    def forward(self, x: torch.Tensor, apply_swish: bool = False, with_coef: bool = False):
        """y, or with ``with_coef`` (bf16 / f16) (y, each sample's sc and sh
        [B, 2, C] f32, as ``group_norm_swish_plain``)."""
        xl = x.movedim(1, -1).contiguous()  # a view when x is channels-last
        fn = fused_group_norm_swish if self.use_kernel else group_norm_swish_plain
        y = fn(xl, self.weight, self.bias, self.num_groups, self.eps, apply_swish, with_coef)
        return (y[0].movedim(-1, 1), y[1]) if with_coef else y.movedim(-1, 1)


class GroupNormWrapper(nn.Module):
    """The reference's GroupNorm(32, eps=1e-6) wrapper; its parameters live
    under ``.gn`` in checkpoints."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.gn = GroupNorm(num_groups, channels, eps)

    def forward(self, x: torch.Tensor, apply_swish: bool = False) -> torch.Tensor:
        return self.gn(x, apply_swish)


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm over the last dim; statistics in f32, output in the
    input's dtype. Computed as ``lns_tpu.ops.norms.LayerNorm`` is (XLA's
    fusion in ``jax.jit``): each mean a sum times 1/dim, the centred value
    divided by ``sqrt(var + eps)`` (not multiplied by its rsqrt), then the
    affine, rounded once (the jitted FAB block's LayerNorm fusions, e.g.
    fused_computation.32 at 12x24: ``divide`` by ``sqrt``);
    ``F.layer_norm``'s rsqrt product differs in the last bit, which a bf16
    rounding shows at ~0.03 % of the elements."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.sum(dim=-1, keepdim=True) * (1.0 / self.dim)
        xc = xf - mean
        var = xc.square().sum(dim=-1, keepdim=True) * (1.0 / self.dim)
        return (xc / torch.sqrt(var + self.eps) * self.weight + self.bias).to(x.dtype)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.InstanceNorm2d defaults (no affine, no running stats) on
    x [B, C, H, W]: normalize each (sample, channel) over H, W with f32
    statistics; output in the input's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
