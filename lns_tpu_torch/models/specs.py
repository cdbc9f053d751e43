"""Layer-sequence specs for the autoencoder variants.

Port of ``lns_tpu.models.specs`` (pure Python, imported separately because
``lns_tpu.models`` pulls in flax). The same spec list drives module
construction and the checkpoint key mapping, so the port's state-dict keys
match the reference's ``encoder.model.{idx}...`` names by construction.

Each spec carries the torch nn.Sequential index (`idx`) its parameters live
under; stateless layers (Swish, nn.Upsample) still consume an index.

Variants: periodic square (NS2d), half-periodic (SW), non-squared
(two-phase). A final "resize" that is an exact 2x is marked ``fused`` and
the conv after it carries ``upsample_2x``: in this package that conv runs a
nearest-2x upsample and then the conv.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class LayerSpec:
    idx: int  # torch nn.Sequential index
    kind: str
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def kw(self) -> Dict[str, Any]:
        return dict(self.kwargs)

    @property
    def name(self) -> str:
        return f"m{self.idx}"


def _spec(idx, kind, **kwargs):
    return LayerSpec(idx, kind, tuple(sorted(kwargs.items())))


STATELESS_KINDS = ("swish", "resize")


# ---------------------------------------------------------------------------
# periodic square variant (modules/autoencoder2d.py)
# ---------------------------------------------------------------------------

def encoder_spec_periodic(cfg) -> List[LayerSpec]:
    channels = list(cfg.encoder_channels)
    fourier_resolutions = list(cfg.fourier_resolutions or [])
    resolution = cfg.resolution
    attn_resolutions = list(cfg.attn_resolutions or [])
    assert (len(channels) - 2) == int(math.log2(resolution // cfg.latent_resolution))
    num_res_blocks = cfg.encoder_res_blocks
    pm = "circular" if cfg.is_periodic else "zeros"

    out: List[LayerSpec] = [
        _spec(0, "conv", features=channels[0], kernel_size=1),
        _spec(1, "swish"),
        _spec(2, "conv", features=channels[0], kernel_size=3, padding=1, padding_mode=pm),
    ]
    idx = 3
    for i in range(len(channels) - 1):
        in_ch = channels[i]
        out_ch = channels[i + 1]
        for _ in range(num_res_blocks):
            out.append(_spec(idx, "resblock", in_channels=in_ch, out_channels=out_ch, padding_mode=pm))
            in_ch = out_ch
            idx += 1
        if resolution in attn_resolutions and cfg.use_attn_enc:
            if not cfg.use_fa:
                out.append(
                    _spec(idx, "sablock", dim=in_ch, heads=cfg.attn_heads, dim_head=cfg.attn_dim,
                          use_pe=True, block_size=resolution**2)
                )
            else:
                out.append(
                    _spec(idx, "fablock", dim=in_ch, dim_head=cfg.attn_dim, latent_dim=cfg.attn_dim,
                          heads=cfg.attn_heads, dim_out=in_ch)
                )
            idx += 1
        if resolution in fourier_resolutions:
            modes = [6, 6] if resolution <= 32 else [10, 10]
            out.append(_spec(idx, "fourier", in_planes=in_ch, planes=out_ch, modes=tuple(modes)))
            idx += 1
        if i != len(channels) - 2:
            out.append(_spec(idx, "down", channels=channels[i + 1], padding_mode=pm))
            resolution //= 2
            idx += 1
    out.append(_spec(idx, "conv", features=channels[-1], kernel_size=3, padding=1, padding_mode=pm))
    out.append(_spec(idx + 1, "gn", groups=32, channels=channels[-1], eps=1e-6, wrapper=True))
    out.append(_spec(idx + 2, "swish"))
    out.append(_spec(idx + 3, "conv", features=cfg.latent_dim, kernel_size=1))
    return out


def decoder_spec_periodic(cfg) -> List[LayerSpec]:
    channels = list(cfg.decoder_channels)
    attn_resolutions = list(cfg.attn_resolutions or [])
    resolution = cfg.latent_resolution
    pm = "circular" if cfg.is_periodic else "zeros"
    num_res_blocks = cfg.decoder_res_blocks
    heads, dim_head = cfg.attn_heads, cfg.attn_dim
    disable_coarse = bool(cfg.disable_coarse_attn)

    in_ch = channels[0]
    out: List[LayerSpec] = [_spec(0, "conv", features=in_ch, kernel_size=1)]
    if not disable_coarse:
        out.append(_spec(1, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        out.append(_spec(2, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                         use_pe=True, block_size=resolution**2))
        out.append(_spec(3, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        idx = 4
    else:
        out.append(_spec(1, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        out.append(_spec(2, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        idx = 3

    for i in range(len(channels)):
        out_ch = channels[i]
        for _ in range(num_res_blocks):
            out.append(_spec(idx, "resblock", in_channels=in_ch, out_channels=out_ch, padding_mode=pm))
            in_ch = out_ch
            idx += 1
        if resolution in attn_resolutions:
            if not cfg.use_fa:
                out.append(_spec(idx, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                                 use_pe=True, block_size=resolution**2))
            else:
                out.append(_spec(idx, "fablock", dim=in_ch, dim_head=dim_head, latent_dim=dim_head,
                                 heads=heads, dim_out=in_ch))
            idx += 1
        if i != 0 and i != len(channels) - 1:
            out.append(_spec(idx, "up", channels=in_ch, padding_mode=pm))
            resolution *= 2
            idx += 1

    # exact-2x final resize moves into the following conv
    # (ConvND.upsample_2x); torch Sequential idx numbering is unchanged —
    # the resize spec stays, marked fused, so checkpoint key parity holds.
    fuse_up = cfg.Ly == 2 * resolution and cfg.Lx == 2 * resolution
    out.append(_spec(idx, "resize", out_h=cfg.Ly, out_w=cfg.Lx, fused=fuse_up))
    idx += 1
    resolution = cfg.Ly
    out.append(_spec(idx, "conv", features=in_ch, kernel_size=3, padding=1, padding_mode=pm,
                     upsample_2x=fuse_up))
    idx += 1
    if cfg.final_smoothing:
        out.append(_spec(idx, "fourier", in_planes=in_ch, planes=in_ch, modes=(16, 16)))
        idx += 1
    else:
        if resolution in attn_resolutions:
            if not cfg.use_fa:
                out.append(_spec(idx, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                                 use_pe=True, block_size=resolution**2))
            else:
                out.append(_spec(idx, "fablock", dim=in_ch, dim_head=dim_head, latent_dim=dim_head,
                                 heads=heads, dim_out=in_ch))
            idx += 1
        out.append(_spec(idx, "conv", features=in_ch, kernel_size=1))
        idx += 1
    # torch: raw nn.GroupNorm(8, C) (eps 1e-5), unlike the 32-group wrapper
    # used everywhere else (autoencoder2d.py:149).
    out.append(_spec(idx, "gn", groups=8, channels=in_ch, eps=1e-5, wrapper=False))
    out.append(_spec(idx + 1, "swish"))
    out.append(_spec(idx + 2, "conv", features=cfg.in_channels, kernel_size=1))
    return out


# ---------------------------------------------------------------------------
# half-periodic variant (modules/autoencoder2d_half_periodic.py)
# ---------------------------------------------------------------------------

def encoder_spec_half_periodic(cfg) -> List[LayerSpec]:
    channels = list(cfg.encoder_channels)
    res_h = cfg.resolutions[0]
    assert (len(channels) - 2) == int(math.log2(res_h // cfg.latent_resolution))
    num_res_blocks = cfg.encoder_res_blocks
    pd = cfg.periodic_direction

    out: List[LayerSpec] = [
        _spec(0, "conv", features=channels[0], kernel_size=1),
        _spec(1, "swish"),
        _spec(2, "hp_resblock", in_channels=channels[0], out_channels=channels[0], periodic_direction=pd),
    ]
    idx = 3
    for i in range(len(channels) - 1):
        in_ch = channels[i]
        out_ch = channels[i + 1]
        for _ in range(num_res_blocks):
            out.append(_spec(idx, "hp_resblock", in_channels=in_ch, out_channels=out_ch, periodic_direction=pd))
            in_ch = out_ch
            idx += 1
        if i != len(channels) - 2:
            out.append(_spec(idx, "hp_down", channels=channels[i + 1], periodic_direction=pd))
            idx += 1
    out.append(_spec(idx, "hp_resblock", in_channels=channels[-1], out_channels=channels[-1], periodic_direction=pd))
    out.append(_spec(idx + 1, "gn", groups=32, channels=channels[-1], eps=1e-6, wrapper=True))
    out.append(_spec(idx + 2, "swish"))
    out.append(_spec(idx + 3, "conv", features=cfg.latent_dim, kernel_size=1))
    return out


def decoder_spec_half_periodic(cfg) -> List[LayerSpec]:
    channels = list(cfg.decoder_channels)
    attn_resolutions = list(cfg.attn_resolutions or [])
    res_h = cfg.latent_resolution
    pd = cfg.periodic_direction
    num_res_blocks = cfg.decoder_res_blocks
    heads, dim_head = cfg.decoder_attn_heads, cfg.decoder_attn_dim
    hw_ratio = cfg.resolutions[1] / cfg.resolutions[0]
    disable_coarse = bool(cfg.disable_coarse_attn)

    def block_size(r):
        return r * int(r * (hw_ratio + 0.5))

    in_ch = channels[0]
    out: List[LayerSpec] = [
        _spec(0, "hp_conv", features=in_ch, kernel_size=3, padding=1, periodic_direction=pd)
    ]
    if not disable_coarse:
        out.append(_spec(1, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                         use_pe=False, block_size=block_size(res_h)))
        out.append(_spec(2, "hp_resblock", in_channels=in_ch, out_channels=in_ch, periodic_direction=pd))
        idx = 3
    else:
        out.append(_spec(1, "hp_resblock", in_channels=in_ch, out_channels=in_ch, periodic_direction=pd))
        out.append(_spec(2, "hp_resblock", in_channels=in_ch, out_channels=in_ch, periodic_direction=pd))
        idx = 3

    for i in range(len(channels)):
        out_ch = channels[i]
        for _ in range(num_res_blocks):
            out.append(_spec(idx, "hp_resblock", in_channels=in_ch, out_channels=out_ch, periodic_direction=pd))
            in_ch = out_ch
            idx += 1
            # attention check sits INSIDE the res-block loop in this variant
            # (autoencoder2d_half_periodic.py:182-195)
            if res_h in attn_resolutions:
                if cfg.use_fa:
                    out.append(_spec(idx, "fablock", dim=in_ch, dim_head=dim_head, latent_dim=dim_head,
                                     heads=heads, dim_out=in_ch))
                else:
                    out.append(_spec(idx, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                                     use_pe=False, block_size=block_size(res_h)))
                idx += 1
        if i != 0 and i != len(channels) - 1:
            out.append(_spec(idx, "hp_up", channels=in_ch, periodic_direction=pd))
            res_h *= 2
            idx += 1

    # exact-2x final resize folds into the following conv (see periodic
    # variant note); aspect is preserved through the stack so Ly==2*res_h
    # implies the width also doubles (shape parity is golden-tested).
    fuse_up = cfg.Ly == 2 * res_h
    out.append(_spec(idx, "resize", out_h=cfg.Ly, out_w=cfg.Lx, fused=fuse_up))
    idx += 1
    res_h = cfg.Ly
    out.append(_spec(idx, "hp_conv", features=in_ch, kernel_size=3, padding=1, periodic_direction=pd,
                     upsample_2x=fuse_up))
    idx += 1
    if cfg.final_smoothing:
        out.append(_spec(idx, "fourier", in_planes=in_ch, planes=in_ch, modes=(16, int(16 * hw_ratio))))
        idx += 1
    else:
        if res_h in attn_resolutions:
            if cfg.use_fa:
                out.append(_spec(idx, "fablock", dim=in_ch, dim_head=dim_head, latent_dim=dim_head,
                                 heads=heads, dim_out=in_ch))
            else:
                out.append(_spec(idx, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                                 use_pe=False, block_size=block_size(res_h)))
            idx += 1
        out.append(_spec(idx, "hp_conv", features=in_ch, kernel_size=3, padding=1, periodic_direction=pd))
        idx += 1
    out.append(_spec(idx, "gn", groups=32, channels=in_ch, eps=1e-6, wrapper=True))
    out.append(_spec(idx + 1, "swish"))
    out.append(_spec(idx + 2, "conv", features=cfg.in_channels, kernel_size=1))
    return out


# ---------------------------------------------------------------------------
# non-squared variant (modules/autoencoder2d_nonsquared.py)
# ---------------------------------------------------------------------------

def encoder_spec_nonsquared(cfg) -> List[LayerSpec]:
    channels = list(cfg.encoder_channels)
    fourier_resolutions = list(cfg.fourier_resolutions or [])
    res_h = cfg.resolutions[0]
    assert (len(channels) - 2) == int(math.log2(res_h // cfg.latent_resolution))
    num_res_blocks = cfg.encoder_res_blocks
    hw_ratio = cfg.hw_ratio
    pm = "circular" if cfg.is_periodic else "zeros"

    out: List[LayerSpec] = [
        _spec(0, "conv", features=channels[0], kernel_size=1),
        _spec(1, "swish"),
        _spec(2, "conv", features=channels[0], kernel_size=3, padding=1, padding_mode=pm),
    ]
    idx = 3
    for i in range(len(channels) - 1):
        in_ch = channels[i]
        out_ch = channels[i + 1]
        for _ in range(num_res_blocks):
            out.append(_spec(idx, "resblock", in_channels=in_ch, out_channels=out_ch, padding_mode=pm))
            in_ch = out_ch
            idx += 1
            # fourier check sits INSIDE the res-block loop in this variant
            # (autoencoder2d_nonsquared.py:46-53)
            if res_h in fourier_resolutions:
                modes = (6, int(6 * hw_ratio)) if res_h <= 32 else (10, int(10 * hw_ratio))
                out.append(_spec(idx, "fourier", in_planes=in_ch, planes=out_ch, modes=modes))
                idx += 1
        if i != len(channels) - 2:
            out.append(_spec(idx, "down", channels=channels[i + 1], padding_mode=pm))
            res_h //= 2
            idx += 1
    out.append(_spec(idx, "resblock", in_channels=channels[-1], out_channels=channels[-1], padding_mode=pm))
    out.append(_spec(idx + 1, "gn", groups=32, channels=channels[-1], eps=1e-6, wrapper=True))
    out.append(_spec(idx + 2, "swish"))
    out.append(_spec(idx + 3, "conv", features=cfg.latent_dim, kernel_size=1))
    return out


def decoder_spec_nonsquared(cfg) -> List[LayerSpec]:
    channels = list(cfg.decoder_channels)
    attn_resolutions = list(cfg.attn_resolutions or [])
    res_h = cfg.latent_resolution
    pm = "circular" if cfg.is_periodic else "zeros"
    num_res_blocks = cfg.decoder_res_blocks
    heads, dim_head = cfg.decoder_attn_heads, cfg.decoder_attn_dim
    hw_ratio = cfg.resolutions[1] / cfg.resolutions[0]
    disable_coarse = bool(cfg.disable_coarse_attn)

    def block_size(r):
        return r * int(r * (hw_ratio + 0.5))

    in_ch = channels[0]
    out: List[LayerSpec] = [
        _spec(0, "conv", features=in_ch, kernel_size=3, padding=1, padding_mode=pm)
    ]
    if not disable_coarse:
        out.append(_spec(1, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        out.append(_spec(2, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                         use_pe=True, block_size=block_size(res_h)))
        out.append(_spec(3, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        idx = 4
    else:
        out.append(_spec(1, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        out.append(_spec(2, "resblock", in_channels=in_ch, out_channels=in_ch, padding_mode=pm))
        idx = 3

    for i in range(len(channels)):
        out_ch = channels[i]
        for _ in range(num_res_blocks):
            out.append(_spec(idx, "resblock", in_channels=in_ch, out_channels=out_ch, padding_mode=pm))
            in_ch = out_ch
            idx += 1
            # attention inside the res-block loop (autoencoder2d_nonsquared.py:193-211)
            if res_h in attn_resolutions:
                if cfg.use_fa:
                    out.append(_spec(idx, "fablock", dim=in_ch, dim_head=dim_head, latent_dim=dim_head,
                                     heads=heads, dim_out=in_ch))
                else:
                    out.append(_spec(idx, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                                     use_pe=True, block_size=block_size(res_h)))
                idx += 1
        if i != 0 and i != len(channels) - 1:
            out.append(_spec(idx, "up", channels=in_ch, padding_mode=pm))
            res_h *= 2
            idx += 1

    fuse_up = cfg.Ly == 2 * res_h
    out.append(_spec(idx, "resize", out_h=cfg.Ly, out_w=cfg.Lx, fused=fuse_up))
    idx += 1
    res_h = cfg.Ly
    out.append(_spec(idx, "conv", features=in_ch, kernel_size=3, padding=1, padding_mode=pm,
                     upsample_2x=fuse_up))
    idx += 1
    if cfg.final_smoothing:
        out.append(_spec(idx, "fourier", in_planes=in_ch, planes=in_ch, modes=(16, int(16 * hw_ratio))))
        idx += 1
    else:
        if res_h in attn_resolutions:
            if cfg.use_fa:
                out.append(_spec(idx, "fablock", dim=in_ch, dim_head=dim_head, latent_dim=dim_head,
                                 heads=heads, dim_out=in_ch))
            else:
                out.append(_spec(idx, "sablock", dim=in_ch, heads=heads, dim_head=dim_head,
                                 use_pe=True, block_size=block_size(res_h)))
            idx += 1
        out.append(_spec(idx, "conv", features=in_ch, kernel_size=3, padding=1, padding_mode=pm))
        idx += 1
    out.append(_spec(idx, "gn", groups=32, channels=in_ch, eps=1e-6, wrapper=True))
    out.append(_spec(idx + 1, "swish"))
    out.append(_spec(idx + 2, "conv", features=cfg.in_channels, kernel_size=1))
    return out


def encoder_spec(cfg) -> List[LayerSpec]:
    v = cfg.ae_variant
    if v == "periodic":
        return encoder_spec_periodic(cfg)
    if v == "half_periodic":
        return encoder_spec_half_periodic(cfg)
    return encoder_spec_nonsquared(cfg)


def decoder_spec(cfg) -> List[LayerSpec]:
    v = cfg.ae_variant
    if v == "periodic":
        return decoder_spec_periodic(cfg)
    if v == "half_periodic":
        return decoder_spec_half_periodic(cfg)
    return decoder_spec_nonsquared(cfg)
