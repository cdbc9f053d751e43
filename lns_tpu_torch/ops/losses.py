"""Loss functions and eval metrics (counterpart of ``lns_tpu.ops.losses``).

``relative_lp_loss`` is the reference's headline eval metric
(training_utils.py:9-23), with its eps floor on the ground-truth norm;
``smooth_l1_loss`` is ``torch.nn.functional.smooth_l1_loss`` (beta 1, mean),
the stage-2 rollout loss (train_stage2_ns2d.py:213), written out as the JAX
package writes it; ``gradient_domain_loss`` the two-phase family's
finite-difference loss (training_utils.py:36-77). Plain tensor functions:
callers pass the ``reduce_dim`` of their layout (the port keeps the JAX
package's channels-last [b, (t,) h, w, c]).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def relative_lp_loss(pred, gt, reduce_dim: Union[int, Tuple[int, ...]] = (-1, -2, -3),
                     reduction: str = "sum", eps: float = 1e-8, reduce_all: bool = False,
                     p: int = 2):
    """Per-sample relative Lp error: sum((pred - gt)^p over reduce_dim) /
    max(sum(gt^p), eps), then the square root (whatever p is, as the
    reference does). ``reduction="mean"`` takes means instead of sums;
    ``reduce_all`` returns the mean over what is left."""
    reduce_fn = torch.mean if reduction == "mean" else torch.sum
    gt_norm = reduce_fn(gt ** p, dim=reduce_dim)
    gt_norm = torch.where(gt_norm < eps, torch.full_like(gt_norm, eps), gt_norm)
    diff = reduce_fn((pred - gt) ** p, dim=reduce_dim) / gt_norm
    if reduce_all:
        return torch.mean(torch.sqrt(diff))
    return torch.sqrt(diff)


def pointwise_correlation(pred, gt, reduce_dim=(-1, -2, -3), eps: float = 1e-8):
    """Normalised inner product over reduce_dim (training_utils.py:26-32)."""
    pred_norm = torch.sqrt(torch.sum(pred ** 2, dim=reduce_dim, keepdim=True))
    gt_norm = torch.sqrt(torch.sum(gt ** 2, dim=reduce_dim, keepdim=True))
    return torch.sum(pred / (pred_norm + eps) * (gt / (gt_norm + eps)), dim=reduce_dim)


def smooth_l1_loss(pred, gt, beta: float = 1.0, reduction: str = "mean"):
    """``torch.nn.functional.smooth_l1_loss`` semantics: 0.5 d^2 / beta
    where d = |pred - gt| < beta, else d - 0.5 beta; reduced by mean, sum
    or not at all ("none")."""
    d = torch.abs(pred - gt)
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def gradient_domain_loss(pred, gt, weight_space: float = 1.0, weight_time: float = 0.0,
                         drop_last_channel: bool = True, spatial_axes: Tuple[int, int] = (-3, -2)):
    """Spatial finite-difference relative L2 (the reference's
    GradientDomainLoss, training_utils.py:36-77) on channels-last fields:
    the last channel (vof) dropped when `drop_last_channel`; central
    differences x[2:] - x[:-2] along each of `spatial_axes`; the two
    ``relative_lp_loss`` terms (``reduce_all``) over those axes, summed and
    weighted by `weight_space`. `weight_time` is accepted and unused, as in
    the reference."""
    if drop_last_channel:
        pred, gt = pred[..., :-1], gt[..., :-1]

    def fd(x, axis):
        n = x.shape[axis]
        return x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)

    ax_h, ax_w = spatial_axes
    rd = (ax_h, ax_w)
    return weight_space * (
        relative_lp_loss(fd(pred, ax_h), fd(gt, ax_h), reduce_dim=rd, reduce_all=True, p=2)
        + relative_lp_loss(fd(pred, ax_w), fd(gt, ax_w), reduce_dim=rd, reduce_all=True, p=2))
