"""The optimizers of both stages (counterpart of ``lns_tpu.train.optim``).

Stage 1: Adam with the config's betas and eps 1e-8, no schedule. Stage 2:
Adam with torch's default betas (0.9, 0.999) and eps 1e-8, and
CosineAnnealingLR(T_max=epochs, eta_min=1e-6) stepped per epoch (reference
train_stage2_ns2d.py:177-187), as one schedule over optimizer steps whose
lr is constant within an epoch.
"""

from __future__ import annotations

import math

import torch


def stage1_optimizer(cfg, params):
    """Adam over `params` at ``cfg.learning_rate`` with betas
    (``cfg.beta1``, ``cfg.beta2``), 0.9 and 0.999 where the config has none,
    and eps 1e-8, as ``lns_tpu.train.optim.stage1_optimizer`` reads them.
    That function's docstring names the reference's betas (0.5, 0.9)
    (train_stage1_ns2d.py:37-54), but its code takes the config's values
    with these defaults; this follows the code."""
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.get("beta1", 0.9), cfg.get("beta2", 0.999)), eps=1e-8)


def cosine_annealing_per_epoch(lr0: float, epochs: int, steps_per_epoch: int,
                               eta_min: float = 1e-6):
    """step -> lr: eta_min + (lr0 - eta_min) (1 + cos(pi e / epochs)) / 2 with
    e = step // steps_per_epoch, clamped at `epochs`."""

    def schedule(step: int) -> float:
        epoch = min(step // max(1, steps_per_epoch), epochs)
        return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2

    return schedule


def stage2_optimizer(cfg, params, steps_per_epoch: int):
    """(Adam over `params`, its LambdaLR). Step the LambdaLR once after every
    optimizer step: optimizer step k (from 0) then runs at the schedule's
    lr for step k, which is optax's lr at update count k."""
    sched = cosine_annealing_per_epoch(cfg.learning_rate, cfg.epochs, steps_per_epoch)
    opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    lr0 = cfg.learning_rate
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: sched(step) / lr0)
