"""Rotary positional embeddings over continuous coordinates (reference:
modules/embedding.py:163-208), as used by the factorized attention, the
sinusoidal embedding of a scalar parameter that conditions the conditional
propagator and encoder (reference: modules/cond_utils.py:19-38), and the
SIREN stack and ``EmbeddingWrapper`` (reference: modules/embedding.py:17-159)."""

from __future__ import annotations

import math

import torch
from torch import nn

from lns_tpu_torch.ops.conv import Dense


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


# -- SIREN (reference: modules/embedding.py:17-159) --------------------------------

class Sine(nn.Module):
    """sin(w0 x)."""

    def __init__(self, w0: float = 1.0):
        super().__init__()
        self.w0 = w0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.w0 * x)


class Siren(nn.Module):
    """One SIREN layer, sin(w0 (x W^T + b)); W [out, in] and b drawn from
    ``initializers.siren_bound`` by ``init_weights_``."""

    def __init__(self, dim_in: int, dim_out: int, w0: float = 1.0, c: float = 6.0,
                 is_first: bool = False, use_bias: bool = True):
        super().__init__()
        self.w0, self.c, self.is_first = w0, c, is_first
        self.weight = nn.Parameter(torch.zeros(dim_out, dim_in))
        self.bias = nn.Parameter(torch.zeros(dim_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.weight.t()
        if self.bias is not None:
            out = out + self.bias
        return torch.sin(self.w0 * out)


class SirenNet(nn.Module):
    """SIREN MLP: the input min-max normalised over dim 1 (when
    ``normalize_input``), ``num_layers`` SIREN layers (``siren_{i}``, the
    first with ``w0_initial``), optional modulation ``mods``, and a linear
    ``last_layer`` (N(0, 0.02), bias 0)."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, num_layers: int,
                 w0: float = 1.0, w0_initial: float = 30.0, use_bias: bool = True,
                 normalize_input: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.normalize_input = normalize_input
        for i in range(num_layers):
            self.add_module(f"siren_{i}", Siren(dim_in if i == 0 else dim_hidden, dim_hidden,
                                                w0=w0_initial if i == 0 else w0,
                                                use_bias=use_bias, is_first=i == 0))
        self.last_layer = Dense(dim_hidden, dim_out)

    def forward(self, x: torch.Tensor, mods: torch.Tensor = None) -> torch.Tensor:
        if self.normalize_input:
            mn, mx = x.amin(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)
            x = (2 * x - mn - mx) / (mx - mn)
        for i in range(self.num_layers):
            x = getattr(self, f"siren_{i}")(x)
        if mods is not None:
            x = x * mods
        return self.last_layer(x)


class EmbeddingWrapper(nn.Module):
    """One embedder per context key (``{name}_emb``; ``siren``: a
    ``SirenNet`` without input normalisation, ``embedding``: a table
    [num_embeddings, out] indexed by the integer value, ``linear``: a
    ``Dense``), each registered under its key. ``forward(context)`` takes a
    dict of values by name and returns [B, n_keys, out] ([B, 1, out] for
    one key)."""

    def __init__(self, keys, settings):
        super().__init__()
        self.keys, self.settings = tuple(keys), tuple(dict(v) for v in settings)
        for k, v in zip(self.keys, self.settings):
            if not k.endswith("emb"):
                raise ValueError(f"context embedding key {k!r} must end with emb")
            enc = v["encoder"]
            if enc == "siren":
                self.add_module(k, SirenNet(v["in_channels"], v["hidden_channels"],
                                            v["out_channels"], v["num_layers"],
                                            normalize_input=False))
            elif enc == "embedding":
                if v["in_channels"] != 1:
                    raise ValueError("an embedding table takes one input channel")
                self.register_parameter(k, nn.Parameter(
                    torch.zeros(v["num_embeddings"], v["out_channels"])))
            elif enc == "linear":
                self.add_module(k, Dense(v["in_channels"], v["out_channels"]))
            else:
                raise ValueError(f"unknown encoder {enc}")

    def tables(self):
        """The ``embedding`` tables."""
        return [getattr(self, k) for k, v in zip(self.keys, self.settings)
                if v["encoder"] == "embedding"]

    def forward(self, context: dict) -> torch.Tensor:
        outs = []
        for k, v in zip(self.keys, self.settings):
            val = context[k[:-4]]
            if v["encoder"] == "embedding":
                out = getattr(self, k)[val.long().reshape(-1)]
            else:
                out = getattr(self, k)(val)
            outs.append(out[:, 0] if out.dim() == 3 else out)
        return outs[0][:, None] if len(outs) == 1 else torch.stack(outs, dim=1)
