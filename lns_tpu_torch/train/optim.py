"""The stage-2 optimizer and its schedule (counterpart of
``lns_tpu.train.optim``): Adam with torch's default betas (0.9, 0.999) and
eps 1e-8, and CosineAnnealingLR(T_max=epochs, eta_min=1e-6) stepped per
epoch (reference train_stage2_ns2d.py:177-187), as one schedule over
optimizer steps whose lr is constant within an epoch.
"""

from __future__ import annotations

import math

import torch


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
