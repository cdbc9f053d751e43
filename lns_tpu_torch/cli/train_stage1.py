"""Stage-1 training entry point (NS2d, SW and the two-phase families, e.g.
configs/SW_stage1_ae.yml):

    python -m lns_tpu_torch.cli.train_stage1 --config configs/ns2d_stage1_ae.yml

Trains the autoencoder on the CUDA card unless given ``--device cpu``. The
config is YAML (PyYAML needed); without it, build a ``Config`` in code and
call ``lns_tpu_torch.train.stage1.Stage1Trainer`` directly.
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    from lns_tpu_torch.cli.common import parse_args
    from lns_tpu_torch.train.stage1 import Stage1Trainer

    args, cfg = parse_args(__doc__, argv)
    trainer = Stage1Trainer(cfg, seed=args.seed, use_wandb=not args.no_wandb,
                            config_path=args.config, device=args.device)
    trainer.train()
    print("Running finished...")


if __name__ == "__main__":
    main()
