"""Stage-1 autoencoder: the periodic square variant (NS2d), the
half-periodic variant (SW) and the non-squared zero-padded variant
(two-phase, and the conditional two-phase family, whose trainer builds the
plain autoencoder: train_stage2_twophase_conditional.py:128), each with
the optional Fourier layers (``final_smoothing``, ``fourier_resolutions``:
``FourierBasicBlock``s); and ``ConditionalSimpleAutoencoder``, whose
encoder is conditioned on a scalar parameter (``CondEncoder``).

``SimpleAutoencoder`` maps NHWC fields to the latent grid and back:
encode = quant_conv(encoder(x)), decode = decoder(post_quant_conv(z)),
mirroring the reference's module skeleton (modules/autoencoder2d.py:160-186)
and its checkpoint names. The encoder and decoder stacks come from the
layer specs (``models.specs``). Modules work on NCHW tensors in
channels-last memory; ``encode``/``decode`` take and return NHWC, as the
JAX package does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lns_tpu_torch.models.specs import LayerSpec, decoder_spec, encoder_spec
from lns_tpu_torch.ops.activations import Swish
from lns_tpu_torch.ops.attention import SABlock
from lns_tpu_torch.ops.conditioning import CondResidualBlock
from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
from lns_tpu_torch.ops.embedding import fourier_embedding
from lns_tpu_torch.ops.factorized_attention import FABlock2D
from lns_tpu_torch.ops.fno import FourierBasicBlock
from lns_tpu_torch.ops.norms import GroupNorm, GroupNormWrapper
from lns_tpu_torch.ops.resblocks import (DownSampleBlock, DownSampleBlock2dHalfPeriodic,
                                         HalfPeriodicResBlock2d, ResidualBlock, UpSampleBlock,
                                         UpSampleBlock2dHalfPeriodic)


class Resize(nn.Module):
    """Nearest resize to (out_h, out_w) with torch's index rule (source
    index floor(i in / out), as ``lns_tpu.ops.sampling.resize_nearest_torch``
    takes it); a no-op when the following conv carries the exact 2x
    (``fused``)."""

    def __init__(self, out_h: int, out_w: int, fused: bool = False):
        super().__init__()
        self.size = (out_h, out_w)
        self.fused = fused

    def forward(self, x):
        if self.fused or tuple(x.shape[2:]) == self.size:
            return x
        return F.interpolate(x, size=self.size, mode="nearest")


def build_layer(spec: LayerSpec, in_ch: int, dtype=None) -> nn.Module:
    """The module for one layer spec, given its input channel count."""
    kw = spec.kw
    kind = spec.kind
    if kind == "conv":
        if kw.get("kernel_size", 1) == 1 and kw.get("stride", 1) == 1:
            return Conv1x1(in_ch, kw["features"], dtype=dtype)
        return ConvND(in_ch, kw["features"], kw["kernel_size"], stride=kw.get("stride", 1),
                      padding=kw.get("padding", 0),
                      padding_mode=kw.get("padding_mode", "zeros"),
                      upsample_2x=kw.get("upsample_2x", False), dtype=dtype)
    if kind == "hp_conv":  # the reference's HalfPeriodicConv2d
        return ConvND(in_ch, kw["features"], kw.get("kernel_size", 3), stride=kw.get("stride", 1),
                      padding=kw.get("padding", 0),
                      padding_mode=f"half_periodic_{kw.get('periodic_direction', 'x')}",
                      upsample_2x=kw.get("upsample_2x", False), dtype=dtype)
    if kind == "gn":
        if kw.get("wrapper"):
            return GroupNormWrapper(kw["channels"], kw["groups"], kw["eps"])
        return GroupNorm(kw["groups"], kw["channels"], kw["eps"])
    if kind == "swish":
        return Swish()
    if kind == "resize":
        return Resize(kw["out_h"], kw["out_w"], kw.get("fused", False))
    if kind == "resblock":
        return ResidualBlock(kw["in_channels"], kw["out_channels"],
                             padding_mode=kw.get("padding_mode", "zeros"), dtype=dtype)
    if kind == "hp_resblock":
        return HalfPeriodicResBlock2d(kw["in_channels"], kw["out_channels"],
                                      kw.get("periodic_direction", "x"), dtype=dtype)
    if kind == "hp_down":
        return DownSampleBlock2dHalfPeriodic(kw["channels"], kw.get("periodic_direction", "x"),
                                             dtype=dtype)
    if kind == "hp_up":
        return UpSampleBlock2dHalfPeriodic(kw["channels"], kw.get("periodic_direction", "x"),
                                           dtype=dtype)
    if kind == "down":
        return DownSampleBlock(kw["channels"], kw.get("padding_mode", "zeros"), dtype=dtype)
    if kind == "up":
        return UpSampleBlock(kw["channels"], kw.get("padding_mode", "zeros"), dtype=dtype)
    if kind == "sablock":
        return SABlock(kw["dim"], kw["heads"], kw["dim_head"], use_pe=kw["use_pe"],
                       block_size=kw["block_size"])
    if kind == "fablock":
        return FABlock2D(kw["dim"], kw["dim_head"], kw["latent_dim"], kw["heads"], kw["dim_out"])
    if kind == "fourier":
        return FourierBasicBlock(kw["in_planes"], kw["planes"], tuple(kw["modes"]))
    raise ValueError(f"unknown layer kind {kind}")


def _out_channels(spec: LayerSpec, in_ch: int) -> int:
    kw = spec.kw
    for key in ("features", "out_channels", "dim_out", "planes"):
        if key in kw:
            return kw[key]
    return in_ch


class SpecSequential(nn.Module):
    """Sequential stack built from a layer-spec list; parameters live under
    ``model.{idx}`` as in the reference. A GroupNorm followed by a swish runs
    as one fused GroupNorm(+swish) call."""

    def __init__(self, specs: Sequence[LayerSpec], in_channels: int, dtype=None):
        super().__init__()
        self.specs = tuple(specs)
        layers, ch = [], in_channels
        for i, spec in enumerate(self.specs):
            if spec.idx != i:
                raise ValueError(f"spec {spec} out of order at position {i}")
            layers.append(build_layer(spec, ch, dtype))
            ch = _out_channels(spec, ch)
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i, n = 0, len(self.specs)
        while i < n:
            layer = self.model[i]
            if self.specs[i].kind == "gn" and i + 1 < n and self.specs[i + 1].kind == "swish":
                x = layer(x, apply_swish=True)
                i += 2
                continue
            x = layer(x)
            i += 1
        return x


class SimpleAutoencoder(nn.Module):
    """Deterministic conv autoencoder (reference SimpleAutoencoder)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpecSequential(encoder_spec(cfg), cfg.in_channels, dtype)
        self.decoder = SpecSequential(decoder_spec(cfg), cfg.latent_dim, dtype)
        self.quant_conv = Conv1x1(cfg.latent_dim, cfg.latent_dim, dtype=dtype)
        self.post_quant_conv = Conv1x1(cfg.latent_dim, cfg.latent_dim, dtype=dtype)

    def use_kernels(self, flag: bool) -> "SimpleAutoencoder":
        """Route the FAB cores and GroupNorms through their kernels (True)
        or their plain versions (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = flag
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> z [B, h, w, latent_dim]."""
        z = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return z.permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, latent_dim] -> x [B, H, W, C]."""
        x = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class CondEncoder(nn.Module):
    """The scalar-parameter-conditioned encoder (reference:
    modules/autoencoder2d_nonsquared.py:71-145; ``lns_tpu.models.
    autoencoder.CondEncoder``): the parameter's Fourier embedding ->
    ``embed`` (Dense -> swish -> Dense, f32); ``to_in`` (1x1 -> swish ->
    conv3); per level ``CondResidualBlock``s (GroupNorm(1) norms, GELU)
    conditioned on the embedding and a stride-2 ``DownSampleBlock`` between
    levels; a last ``CondResidualBlock`` ``to_out_conv``; ``to_out``
    (GN(32)+swish -> 1x1 to the latent width). x [B, C, H, W], param [B]."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None):
        super().__init__()
        channels = list(cfg.encoder_channels)
        pm = "circular" if cfg.is_periodic else "zeros"
        cond_ch = self.cond_ch = cfg.cond_emb_channels
        self.embed = nn.Sequential(Dense(cond_ch, channels[0]), Swish(),
                                   Dense(channels[0], cond_ch))
        self.to_in = nn.Sequential(Conv1x1(cfg.in_channels, channels[0], dtype=dtype), Swish(),
                                   ConvND(channels[0], channels[0], 3, padding=1,
                                          padding_mode=pm, dtype=dtype))
        levels = []
        for i in range(len(channels) - 1):
            blocks, in_ch = [], channels[i]
            for _ in range(cfg.encoder_res_blocks):
                blocks.append(CondResidualBlock(in_ch, channels[i + 1], cond_ch, norm=True,
                                                padding_mode=pm, dtype=dtype))
                in_ch = channels[i + 1]
            level = [nn.ModuleList(blocks)]
            if i != len(channels) - 2:
                level.append(DownSampleBlock(channels[i + 1], pm, dtype=dtype))
            levels.append(nn.ModuleList(level))
        self.layers = nn.ModuleList(levels)
        self.to_out_conv = CondResidualBlock(channels[-1], channels[-1], cond_ch, norm=True,
                                             padding_mode=pm, dtype=dtype)
        self.to_out = nn.Sequential(GroupNormWrapper(channels[-1], 32, 1e-6), Swish(),
                                    Conv1x1(channels[-1], cfg.latent_dim, dtype=dtype))

    def forward(self, x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
        emb = self.embed(fourier_embedding(param, self.cond_ch))
        h = self.to_in(x)
        for level in self.layers:
            for block in level[0]:
                h = block(h, emb)
            if len(level) > 1:
                h = level[1](h)
        h = self.to_out_conv(h, emb)
        return self.to_out[2](self.to_out[0](h, apply_swish=True))


class ConditionalSimpleAutoencoder(nn.Module):
    """The conditional-encoder autoencoder (reference:
    modules/autoencoder2d_nonsquared.py:279-305): ``CondEncoder``, the
    config's spec-built decoder, ``quant_conv`` and ``post_quant_conv``.
    ``encode(x, param)`` and ``decode(z)`` take and return NHWC."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = CondEncoder(cfg, dtype)
        self.decoder = SpecSequential(decoder_spec(cfg), cfg.latent_dim, dtype)
        self.quant_conv = Conv1x1(cfg.latent_dim, cfg.latent_dim, dtype=dtype)
        self.post_quant_conv = Conv1x1(cfg.latent_dim, cfg.latent_dim, dtype=dtype)

    use_kernels = SimpleAutoencoder.use_kernels
    decode = SimpleAutoencoder.decode

    def encode(self, x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C], param [B] -> z [B, h, w, latent_dim]."""
        return self.quant_conv(self.encoder(x.permute(0, 3, 1, 2), param)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x, param))
