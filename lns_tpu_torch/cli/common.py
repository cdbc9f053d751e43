"""Shared CLI plumbing: --config / --seed / --comment as the reference's
entry points take them (train_stage1_ns2d.py:151-165), --no-wandb, and
--device in place of the JAX package's --mesh."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from lns_tpu_torch.config import load_config


def parse_args(description: str, argv: Optional[Sequence[str]] = None):
    """(args, cfg) from `argv` (the command line when None); the config is
    a reference-format YAML file."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, required=True, help="Path to the config file")
    p.add_argument("--seed", type=int, default=1234, help="Random seed")
    p.add_argument("--comment", type=str, default="", help="Comment")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to train on (default: the CUDA card; 'cpu' for the CPU)")
    p.add_argument("--no-wandb", action="store_true")
    args = p.parse_args(argv)
    return args, load_config(args.config)
