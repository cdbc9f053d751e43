"""Conditioning blocks (reference: modules/cond_utils.py, from pdearena,
MIT), the counterpart of ``lns_tpu.ops.conditioning``: ``embed_sequential``
and ``CondResidualBlock``, the wide residual block with an additive or a
scale-shift (AdaGN) injection of a conditioning vector. Its ``conv2`` is
zero-initialised (the reference's ``zero_module``, ``initializers.
zero_init``), so the block starts as its shortcut plus nothing."""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from lns_tpu_torch.ops.activations import get_activation
from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
from lns_tpu_torch.ops.initializers import zero_init
from lns_tpu_torch.ops.norms import GroupNorm


def _positional_inputs(layer) -> int:
    fn = layer.forward if isinstance(layer, nn.Module) else layer
    try:
        return sum(1 for p in inspect.signature(fn).parameters.values()
                   if p.default is inspect.Parameter.empty
                   and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
    except (TypeError, ValueError):
        return 1


def embed_sequential(layers, x, emb):
    """Apply `layers` in turn, passing `emb` to those whose call takes two
    positional inputs (the reference's ``EmbedSequential``)."""
    for layer in layers:
        x = layer(x, emb) if _positional_inputs(layer) >= 2 else layer(x)
    return x


class CondResidualBlock(nn.Module):
    """h = conv1(act(norm1(x))); additive: h = conv2(act(norm2(h + e)));
    scale-shift: h = conv2(act(norm2(h) (1 + scale) + shift)); out = h +
    shortcut(x), e = ``cond_emb(emb)`` [B, C_out] (or 2 C_out, split into
    scale and shift). The norms are GroupNorm(``n_groups``, eps 1e-5),
    through kernel 3 without its swish.

    The projection takes no dtype: it follows the f32 vector, so with a
    bf16 block ``h + e`` (and the scale-shift product) promote to f32 and
    ``norm2`` and the activation run in f32 before ``conv2`` casts back, as
    in the JAX block. Rounding, as the jitted JAX block computes it
    (measured against it on the CPU: XLA drops a bf16 rounding that an f32
    consumer reads back): conv1's product and bias are each rounded to the
    block's dtype and summed in f32, unrounded, before e is added (or the
    scale and shift applied, without norm2); with norm2 in the scale-shift
    form, its normalised value ``h sc`` is rounded and ``+ sh`` is not.
    The rounding differs from the jitted JAX block's on 0.07 % of the
    elements of the additive form and 0.013 % of the scale-shift form, sum
    order (tests/test_torch_port_library.py)."""

    def __init__(self, in_channels: int, out_channels: int, cond_channels: int,
                 activation: str = "gelu", norm: bool = False, n_groups: int = 1,
                 use_scale_shift_norm: bool = False, padding_mode: str = "zeros",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act = get_activation(activation)
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm1 = GroupNorm(n_groups, in_channels, eps=1e-5) if norm else None
        self.conv1 = ConvND(in_channels, out_channels, 3, padding=1, padding_mode=padding_mode,
                            dtype=dtype)
        self.cond_emb = Dense(cond_channels,
                              2 * out_channels if use_scale_shift_norm else out_channels)
        self.norm2 = GroupNorm(n_groups, out_channels, eps=1e-5) if norm else None
        self.conv2 = zero_init(ConvND(out_channels, out_channels, 3, padding=1,
                                      padding_mode=padding_mode, dtype=dtype))
        self.shortcut = (Conv1x1(in_channels, out_channels)
                         if in_channels != out_channels else None)

    def _conv1_sum(self, a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """conv1's product and bias, each rounded to the block's dtype,
        summed in `dt` (the vector's, f32): unrounded there."""
        p = self.conv1.product(a)
        return p.to(dt) + self.conv1.bias.to(p.dtype).to(dt)[:, None, None]

    def _norm2_unrounded(self, a: torch.Tensor) -> torch.Tensor:
        """norm2 of conv1's (rounded) output with the normalised value's sum
        left unrounded: in bf16 / f16 ``round(h sc) + sh`` in f32, from
        kernel 3's rounded coefficients, as the jitted JAX block computes it
        before the f32 scale and shift. Its gradient is kernel 3's y's (the
        two differ by y's last rounding, exactly, whose gradient is zero)."""
        h = self.conv1(a)
        if h.dtype == torch.float32:
            return self.norm2(h)
        y, coef = self.norm2(h, with_coef=True)
        sc, sh = coef[:, 0, :, None, None], coef[:, 1, :, None, None]
        y = y.float()
        return y + ((h * sc.to(h.dtype)).float() + sh - y).detach()

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = x if self.norm1 is None else self.norm1(x)
        a = self.act(h)
        e = self.cond_emb(emb)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self._conv1_sum(a, e.dtype) if self.norm2 is None else self._norm2_unrounded(a)
            h = h * (1 + scale) + shift
        else:
            h = self._conv1_sum(a, e.dtype) + e
            if self.norm2 is not None:
                h = self.norm2(h)
        h = self.conv2(self.act(h))
        return h + (x if self.shortcut is None else self.shortcut(x))
