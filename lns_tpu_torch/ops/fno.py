"""FNO composite blocks (reference: modules/basics.py:531-715), the
counterpart of ``lns_tpu.ops.fno``, on channel-first tensors in
channels-last memory. Parameter names are the JAX package's module names
(``fourier``, ``conv``; ``token_mixer``, ``cm_norm``, ...), which for
``FourierBasicBlock`` are also the reference's."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lns_tpu_torch.ops.activations import get_activation, gelu
from lns_tpu_torch.ops.conv import Conv1x1
from lns_tpu_torch.ops.initializers import zero_init
from lns_tpu_torch.ops.norms import GroupNorm, instance_norm_2d
from lns_tpu_torch.ops.spectral import spectral


class FourierBasicBlock(nn.Module):
    """act(spectral conv(x) + 1x1 conv(x)), plus x when ``residual``. The
    1x1 bypass takes no dtype (it follows x's), as in the JAX block."""

    def __init__(self, in_planes: int, planes: int, modes: Sequence[int],
                 activation: str = "gelu", residual: bool = True):
        super().__init__()
        self.act = get_activation(activation)
        self.residual = residual
        self.fourier = spectral(in_planes, planes, modes)
        self.conv = Conv1x1(in_planes, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.fourier(x) + self.conv(x))
        return x + out if self.residual else out


def _token_norm(norm: str, channels: int) -> Optional[nn.Module]:
    if norm not in ("in", "ln", "none"):
        raise ValueError(f"norm {norm!r}: 'in', 'ln' or 'none'")
    return GroupNorm(1, channels, eps=1e-5) if norm == "ln" else None


class ResFNOMixerBlock(nn.Module):
    """Metaformer block: norm (``in`` instance norm, ``ln`` GroupNorm(1)
    through kernel 3, or ``none``) -> spectral token mixer -> GroupNorm(1)
    -> 1x1 -> GELU -> 1x1 channel mixer, residual (a 1x1 ``channel_up``
    when the widths differ)."""

    def __init__(self, in_channels: int, out_channels: int, modes: Sequence[int],
                 norm: str = "in"):
        super().__init__()
        self.norm_kind = norm
        self.norm = _token_norm(norm, in_channels)
        self.token_mixer = spectral(in_channels, out_channels, modes)
        self.cm_norm = GroupNorm(1, out_channels, eps=1e-5)
        self.cm_fc1 = Conv1x1(out_channels, out_channels)
        self.cm_fc2 = Conv1x1(out_channels, out_channels)
        self.channel_up = (Conv1x1(in_channels, out_channels)
                           if in_channels != out_channels else None)

    def _mixed(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_kind == "in":
            return self.token_mixer(instance_norm_2d(x))
        return self.token_mixer(x if self.norm is None else self.norm(x))

    def _channel_mix(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h = self.cm_fc2(gelu(self.cm_fc1(self.cm_norm(h))))
        return (x if self.channel_up is None else self.channel_up(x)) + h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._channel_mix(x, self._mixed(x))


class CondResFNOMixerBlock(ResFNOMixerBlock):
    """``ResFNOMixerBlock`` whose token mixer's output is scaled by ``1 +
    gate``, the gate a GELU MLP of the conditioning vector [B, C_in] whose
    second layer is zero-initialised. The gate follows the (f32) vector, so
    a bf16 block runs its channel mixer in f32, as the JAX block does. 2D
    only."""

    def __init__(self, in_channels: int, out_channels: int, modes: Sequence[int],
                 norm: str = "in"):
        super().__init__(in_channels, out_channels, modes, norm)
        self.cond_fc1 = Conv1x1(in_channels, in_channels)
        self.cond_fc2 = zero_init(Conv1x1(in_channels, in_channels))

    def forward(self, x: torch.Tensor, cond_emb: torch.Tensor) -> torch.Tensor:
        gate = self.cond_fc2.forward_last(gelu(self.cond_fc1.forward_last(cond_emb)))
        return self._channel_mix(x, self._mixed(x) * (1.0 + gate[:, :, None, None]))
