"""Spatial padding of NCHW tensors: zeros (torch padding_mode='zeros') and
circular (torch padding_mode='circular', a wrap).

Padding amounts are (lo, hi) pairs per spatial axis in (H, W, ...) order, so
the asymmetric (0, 1) pad of the reference's DownSampleBlock
(modules/basics.py:317-327) is expressible.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Pad2 = Tuple[int, int]


def pad_nd(x: torch.Tensor, pads: Sequence[Pad2], mode: str = "zeros") -> torch.Tensor:
    """Pad the spatial axes of x [B, C, *spatial]; one (lo, hi) pair per
    spatial axis. mode: 'zeros' | 'circular'."""
    flat = []
    for lo, hi in reversed(list(pads)):  # F.pad takes the last axis first
        flat += [lo, hi]
    if mode == "zeros":
        return F.pad(x, flat, mode="constant")
    if mode == "circular":
        return F.pad(x, flat, mode="circular")
    raise ValueError(f"unknown padding mode {mode}")
