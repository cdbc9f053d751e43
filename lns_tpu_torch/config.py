"""Config system: reads the reference's flat YAML experiment files unchanged.

Counterpart of ``lns_tpu.config``. Missing keys resolve to ``None`` (several
shipped configs omit keys the model code reads), ``replace`` returns an
edited copy, and the workload helpers tell which model family a config
describes. ``yaml`` is imported inside ``load_config`` only, so the package
imports without PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config:
    """Attribute-access view over a nested dict; missing keys -> None."""

    def __init__(self, d: Optional[Dict[str, Any]] = None, **kwargs):
        object.__setattr__(self, "_data", {})
        for k, v in {**(d or {}), **kwargs}.items():
            self._data[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        return self._data.get(name, None)

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._data.get(name, None)

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        v = self._data.get(name, None)
        return default if v is None else v

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self._data.items()}

    def replace(self, **kwargs) -> "Config":
        new = Config(copy.deepcopy(self.to_dict()))
        for k, v in kwargs.items():
            new[k] = v
        return new

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    @property
    def ae_variant(self) -> str:
        """'half_periodic' (``periodic_direction`` set; SW), 'nonsquared'
        (rectangular ``resolutions``; two-phase) or 'periodic' (square
        ``resolution``; NS2d)."""
        if self.periodic_direction is not None:
            return "half_periodic"
        if self.resolutions is not None:
            return "nonsquared"
        return "periodic"

    @property
    def is_conditional(self) -> bool:
        """Conditional propagator configs carry ``cond_channels``."""
        return self.cond_channels is not None

    @property
    def workload(self) -> str:
        if self.ae_variant == "half_periodic":
            return "sw"
        if self.ae_variant == "nonsquared":
            return "twophase_conditional" if self.is_conditional else "twophase"
        return "ns2d"


def load_config(path: str) -> Config:
    """Load a reference-format YAML experiment file."""
    import yaml

    with open(path, "r") as f:
        return Config(yaml.safe_load(f))


def ns2d_config(res: int = 64, latent_res: int = 8) -> Config:
    """The NS2d latent surrogate at the reference's shipped widths: 64x64x1
    field, 8x8x16 latent, 3x128 SimpleCNN propagator, FAB decoder attention
    at 16x16 and 32x32 (configs/ns2d_stage2_prop.yml)."""
    return Config(
        latent_dim=16, Ly=res, Lx=res, resolution=res, in_channels=1,
        latent_resolution=latent_res, is_periodic=True,
        encoder_channels=[64, 64, 64, 128, 128], fourier_resolutions=[],
        encoder_res_blocks=1, use_attn_enc=False,
        use_fa=True, decoder_channels=[128, 128, 64, 64],
        attn_resolutions=[16, 32], decoder_res_blocks=1, final_smoothing=False,
        attn_heads=8, attn_dim=64, disable_coarse_attn=False,
        prop_n_block=3, prop_n_embd=128, dilation=2, noise_level=0.0,
        out_tw=2, interval=1,
    )


def sw_config() -> Config:
    """The SW (shallow-water) latent surrogate at the reference's widths:
    96x192x3 field (u, v, pressure), 12x24x64 latent, half-periodic in x,
    FAB decoder attention at 24x48 and 48x96, a 4 x 128 SimpleCNN with
    dilation 3 and out_tw 5 (configs/SW_stage1_ae.yml, SW_stage2_prop.yml;
    the JAX package's benchmarks/run_benchmarks.py: sw_cfg)."""
    return Config(
        latent_dim=64, Ly=96, Lx=192, resolutions=[96, 192], in_channels=3,
        latent_resolution=12, periodic_direction="x", hw_ratio=2,
        encoder_channels=[64, 64, 64, 128, 128], fourier_resolutions=[],
        encoder_res_blocks=1, use_fa=True, decoder_channels=[128, 128, 64, 64],
        attn_resolutions=[24, 48], decoder_res_blocks=1, final_smoothing=False,
        decoder_attn_heads=8, decoder_attn_dim=64, disable_coarse_attn=False,
        prop_n_block=4, prop_n_embd=128, dilation=3, out_tw=5, noise_level=0.0,
    )


def twophase_config() -> Config:
    """The two-phase (tank sloshing) latent surrogate at the reference's
    widths: 61x121x4 field (vx, vy, pressure, vof), 7x15x64 latent, zero
    padding, an SABlock at 7x15 in the decoder (its resolutions 7, 14, 28
    hold no FAB: ``attn_resolutions`` [15, 30] name none of them), a 4 x 128
    SimpleCNN with dilation 2 and zeros padding, in_tw 1, out_tw 5 (the JAX
    package's benchmarks/run_benchmarks.py: twophase_cfg)."""
    return Config(
        latent_dim=64, Ly=61, Lx=121, resolutions=[61, 121], in_channels=4,
        latent_resolution=7, is_periodic=False, hw_ratio=2,
        encoder_channels=[64, 64, 64, 128, 128], fourier_resolutions=[],
        encoder_res_blocks=1, use_fa=True, decoder_channels=[128, 128, 64, 64],
        attn_resolutions=[15, 30], decoder_res_blocks=1, final_smoothing=False,
        decoder_attn_heads=8, decoder_attn_dim=64, disable_coarse_attn=False,
        prop_n_block=4, prop_n_embd=128, dilation=2, in_tw=1, out_tw=5, noise_level=0.0,
    )


def twophase_conditional_config() -> Config:
    """The conditional two-phase family: ``twophase_config()`` with a
    propagator conditioned on each case's driving frequency through FiLM
    (``CondSimpleCNN``; the reference's configs/twophase_stage2_cond_prop.yml
    as the JAX package spells it, benchmarks/convergence_families.py:146-147).
    The autoencoder is the plain one, as the reference's conditional
    trainer builds it (train_stage2_twophase_conditional.py:128); the
    conditioning embedding is ``latent_dim`` wide (64), not
    ``cond_emb_channels``, as the JAX package builds it."""
    return twophase_config().replace(cond_channels=1, cond_emb_channels=64)
