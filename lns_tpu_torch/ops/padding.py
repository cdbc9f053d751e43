"""Spatial padding of NCHW tensors: zeros (torch padding_mode='zeros'),
circular (torch padding_mode='circular', a wrap) and half-periodic (a wrap
along one axis, zeros along the other; reference:
modules/autoencoder2d_half_periodic.py:26-52).

Padding amounts are (lo, hi) pairs per spatial axis in (H, W, ...) order, so
the asymmetric (0, 1) pad of the reference's DownSampleBlock
(modules/basics.py:317-327) is expressible.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Pad2 = Tuple[int, int]

# half-periodic mode -> the spatial axis (0 = H, 1 = W) that wraps
HALF_PERIODIC_AXIS = {"half_periodic_y": 0, "half_periodic_x": 1}


def pad_nd(x: torch.Tensor, pads: Sequence[Pad2], mode: str = "zeros") -> torch.Tensor:
    """Pad the spatial axes of x [B, C, *spatial]; one (lo, hi) pair per
    spatial axis. mode: 'zeros' | 'circular' | 'half_periodic_x' |
    'half_periodic_y' (2 spatial axes: W or H wraps, the other is
    zero-padded)."""
    pads = [tuple(p) for p in pads]
    if mode in HALF_PERIODIC_AXIS:
        if len(pads) != 2:
            raise ValueError(f"{mode} pads two spatial axes, got {len(pads)}")
        axis = HALF_PERIODIC_AXIS[mode]
        wrap = [(0, 0), (0, 0)]
        wrap[axis] = pads[axis]
        zero = list(pads)
        zero[axis] = (0, 0)
        return pad_nd(pad_nd(x, wrap, "circular"), zero, "zeros")
    flat = []
    for lo, hi in reversed(pads):  # F.pad takes the last axis first
        flat += [lo, hi]
    if mode == "zeros":
        return F.pad(x, flat, mode="constant")
    if mode == "circular":
        return F.pad(x, flat, mode="circular")
    raise ValueError(f"unknown padding mode {mode}")
