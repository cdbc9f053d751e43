"""Latent-space propagator: ``SimpleCNN`` with ``DilatedResidualBlock``s
(reference: train_stage2_ns2d.py:25-87), circular padding on NS2d,
half-periodic-x on SW (train_stage2_SW.py) and zeros on the two-phase
family (train_stage2_twophase.py). A half-periodic conv rounds
as ``ops.conv.ConvND`` states (the JAX module step's rounding points); the
fused rollout kernel sums the nine taps in one accumulator, as the JAX
package's Pallas rollout does.

Checkpoint names follow the reference trainer: ``in_proj``,
``net.{i}.conv.{0,1,3,5}``, ``net.{i}.ffn.{0,1,3}``, ``out_proj.{0.gn,1}``.
``forward`` takes and returns NHWC latents [B, H, W, C]; the fused rollout
kernel (``kernels.prop_rollout``) runs many steps of the same network.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lns_tpu_torch.ops.activations import GELU, gelu
from lns_tpu_torch.ops.conv import Conv1x1, ConvND
from lns_tpu_torch.ops.norms import GroupNorm, GroupNormWrapper


class DilatedResidualBlock(nn.Module):
    """GN(1) -> conv3 -> GELU -> dilated conv3 -> GELU -> conv3, residual;
    then GN(1) -> 1x1 -> GELU -> 1x1, residual."""

    def __init__(self, dim: int, dilation: int = 1, padding_mode: str = "circular",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def conv3(dil):
            return ConvND(dim, dim, 3, padding=dil, dilation=dil,
                          padding_mode=padding_mode, dtype=dtype)

        self.conv = nn.Sequential(GroupNorm(1, dim, eps=1e-5), conv3(1), GELU(),
                                  conv3(dilation), GELU(), conv3(1))
        self.ffn = nn.Sequential(GroupNorm(1, dim, eps=1e-5),
                                 Conv1x1(dim, dim, use_bias=False, dtype=dtype), GELU(),
                                 Conv1x1(dim, dim, use_bias=False, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.conv[1](self.conv[0](x)))
        h = gelu(self.conv[3](h))
        x = x + self.conv[5](h)
        f = gelu(self.ffn[1](self.ffn[0](x)))
        return x + self.ffn[3](f)


class SimpleCNN(nn.Module):
    """1x1 in_proj -> n DilatedResidualBlocks -> GN(32) + 1x1 out_proj;
    predicts the next latent state directly."""

    def __init__(self, latent_dim: int, prop_n_block: int, prop_n_embd: int,
                 dilation: int = 2, padding_mode: str = "circular",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.prop_n_block = prop_n_block
        self.dilation = dilation
        self.padding_mode = padding_mode
        self.in_proj = Conv1x1(latent_dim, prop_n_embd, dtype=dtype)
        self.net = nn.Sequential(*[
            DilatedResidualBlock(prop_n_embd, dilation, padding_mode, dtype)
            for _ in range(prop_n_block)])
        self.out_proj = nn.Sequential(GroupNormWrapper(prop_n_embd, 32, 1e-6),
                                      Conv1x1(prop_n_embd, latent_dim, dtype=dtype))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """One step: z [B, H, W, C_lat] -> [B, H, W, C_lat]."""
        h = self.net(self.in_proj(z.permute(0, 3, 1, 2)))
        return self.out_proj(h).permute(0, 2, 3, 1)


# the SimpleCNN's padding per workload (lns_tpu/models/propagator.py:256)
PADDING = {"ns2d": "circular", "sw": "half_periodic_x", "twophase": "zeros"}


def build_propagator(cfg, dtype: Optional[torch.dtype] = None) -> SimpleCNN:
    """The stage-2 propagator of a config: a SimpleCNN, circular on NS2d,
    half-periodic in x on SW, zero-padded on the two-phase family."""
    if cfg.is_conditional:
        raise NotImplementedError("the conditional propagator (CondSimpleCNN) is not ported "
                                  "yet; it comes with the conditional two-phase family")
    return SimpleCNN(cfg.latent_dim, cfg.prop_n_block, cfg.prop_n_embd,
                     dilation=cfg.dilation, padding_mode=PADDING[cfg.workload], dtype=dtype)
