"""Rotary positional embeddings over continuous coordinates (reference:
modules/embedding.py:163-208), as used by the factorized attention, and the
sinusoidal embedding of a scalar parameter that conditions the conditional
propagator (reference: modules/cond_utils.py:19-38)."""

from __future__ import annotations

import math

import torch
from torch import nn


def fourier_freqs(dim: int, max_period: int = 10000, device=None) -> torch.Tensor:
    """``exp(-log(max_period) arange(dim // 2) / (dim // 2))`` [dim // 2] f32,
    as the jitted JAX ``fourier_embedding`` has it: XLA folds the constant,
    the exponent's argument rounded in f32 and the exponential rounded once
    from a wider value (an f32 ``exp`` misses it in the last bit at some
    entries)."""
    half = dim // 2
    arg = torch.arange(half, dtype=torch.float32, device=device) * -math.log(max_period) / half
    return torch.exp(arg.double()).float()


def fourier_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """[N] scalars -> [N, dim] f32: ``cos(t f) | sin(t f)``, f the
    ``fourier_freqs``, zero-padded by one column when `dim` is odd
    (``lns_tpu.ops.embedding.fourier_embedding``). The product with t, cos
    and sin are f32, within an f32 ulp of XLA's."""
    args = t.float()[:, None] * fourier_freqs(dim, max_period, t.device)[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def rotary_inv_freq(dim: int) -> torch.Tensor:
    """The reference's registered ``inv_freq`` buffer, ``1 / 10000 **
    (arange(0, dim, 2) / dim)``: [dim / 2] f32, with the values the jitted
    JAX package uses (XLA folds the constant in f64 and rounds once; an f32
    ``pow`` differs in the last bit at 19 of 64 entries for dim 128)."""
    x = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    return (1.0 / 10000.0 ** x.double()).float()


def rotary_freqs(coordinates: torch.Tensor, dim: int, min_freq: float = 1.0 / 64,
                 scale: float = 1.0, inv_freq: torch.Tensor = None) -> torch.Tensor:
    """RotaryEmbedding.forward: coordinates [b, n] -> freqs [b, n, dim]."""
    if inv_freq is None:
        inv_freq = rotary_inv_freq(dim).to(coordinates.device)
    t = coordinates.float() * (scale / min_freq)
    freqs = torch.einsum("...i,j->...ij", t, inv_freq.float())
    return torch.cat((freqs, freqs), dim=-1)


class RotaryEmbedding(nn.Module):
    """The reference module. The frequencies use ``rotary_inv_freq(dim)``,
    the values of the jitted JAX package, held on the module's device in a
    buffer outside the state dict. The reference's checkpoint holds an
    ``inv_freq`` buffer of its own (an f32 ``pow``, which can miss those in
    the last bit): the state dict writes the reference's values under that
    key, and a load takes the key and drops it."""

    def __init__(self, dim: int, min_freq: float = 1.0 / 64, scale: float = 1.0):
        super().__init__()
        self.dim = dim
        self.min_freq = min_freq
        self.scale = scale
        self.register_buffer("freq", rotary_inv_freq(dim), persistent=False)

    def forward(self, coordinates: torch.Tensor) -> torch.Tensor:
        return rotary_freqs(coordinates, self.dim, self.min_freq, self.scale, self.freq)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        destination[prefix + "inv_freq"] = 1.0 / (
            10000 ** (torch.arange(0, self.dim, 2, dtype=torch.float32) / self.dim))

    def _load_from_state_dict(self, state_dict, prefix, *args):
        state_dict.pop(prefix + "inv_freq", None)
        super()._load_from_state_dict(state_dict, prefix, *args)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) -> (-x2, x1) over the two halves of the last dim."""
    d = x.shape[-1] // 2
    return torch.cat((-x[..., d:], x[..., :d]), dim=-1)


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    return t * freqs.cos() + rotate_half(t) * freqs.sin()
