"""Shared CLI plumbing: --config / --seed / --comment as the reference's
entry points take them (train_stage1_ns2d.py:151-165), --no-wandb, and
--device. Where the JAX package takes ``--mesh`` (a data-parallel mesh over
the local devices), the port takes torchrun's world: under ``torchrun
--nproc_per_node N`` each process trains on one device of an N-rank
data-parallel run (``lns_tpu_torch.parallel``; NCCL on the card, gloo with
``--device cpu``), and one process without torchrun trains on one device."""

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
                   help="torch device to train on (default: the CUDA card, cuda:LOCAL_RANK "
                        "under torchrun; 'cpu' for the CPU)")
    p.add_argument("--no-wandb", action="store_true")
    args = p.parse_args(argv)
    return args, load_config(args.config)


def run_trainer(trainer_cls, description: str, argv: Optional[Sequence[str]] = None):
    """Parse the command line, join torchrun's process group when there is
    one, build `trainer_cls` on this process's device and train."""
    from lns_tpu_torch.parallel import ddp

    args, cfg = parse_args(description, argv)
    device = ddp.init_from_env(args.device)
    try:
        trainer = trainer_cls(cfg, seed=args.seed, use_wandb=not args.no_wandb,
                              config_path=args.config, device=device)
        trainer.train()
    finally:
        ddp.shutdown()
    print("Running finished...")
