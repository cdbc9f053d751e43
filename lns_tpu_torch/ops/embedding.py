"""Rotary positional embeddings over continuous coordinates (reference:
modules/embedding.py:163-208), as used by the factorized attention."""

from __future__ import annotations

import torch
from torch import nn


def rotary_inv_freq(dim: int) -> torch.Tensor:
    """The reference's registered ``inv_freq`` buffer: [dim / 2] f32."""
    return 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))


def rotary_freqs(coordinates: torch.Tensor, dim: int, min_freq: float = 1.0 / 64,
                 scale: float = 1.0, inv_freq: torch.Tensor = None) -> torch.Tensor:
    """RotaryEmbedding.forward: coordinates [b, n] -> freqs [b, n, dim]."""
    if inv_freq is None:
        inv_freq = rotary_inv_freq(dim).to(coordinates.device)
    t = coordinates.float() * (scale / min_freq)
    freqs = torch.einsum("...i,j->...ij", t, inv_freq.float())
    return torch.cat((freqs, freqs), dim=-1)


class RotaryEmbedding(nn.Module):
    """The reference module: holds ``inv_freq`` as a buffer, which is part
    of its checkpoint."""

    def __init__(self, dim: int, min_freq: float = 1.0 / 64, scale: float = 1.0):
        super().__init__()
        self.dim = dim
        self.min_freq = min_freq
        self.scale = scale
        self.register_buffer("inv_freq", rotary_inv_freq(dim))

    def forward(self, coordinates: torch.Tensor) -> torch.Tensor:
        return rotary_freqs(coordinates, self.dim, self.min_freq, self.scale,
                            self.inv_freq)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) -> (-x2, x1) over the two halves of the last dim."""
    d = x.shape[-1] // 2
    return torch.cat((-x[..., d:], x[..., :d]), dim=-1)


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    return t * freqs.cos() + rotate_half(t) * freqs.sin()
