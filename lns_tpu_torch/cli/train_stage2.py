"""Stage-2 training entry point (NS2d, SW, two-phase and conditional two-phase, e.g.
configs/SW_stage2_prop.yml or configs/twophase_stage2_cond_prop.yml):

    python -m lns_tpu_torch.cli.train_stage2 --config configs/ns2d_stage2_prop.yml

Trains on the CUDA card unless given ``--device cpu``. The config is YAML
(PyYAML needed); without it, build a ``Config`` in code and call
``lns_tpu_torch.train.stage2.Stage2Trainer`` directly.
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    from lns_tpu_torch.cli.common import parse_args
    from lns_tpu_torch.train.stage2 import Stage2Trainer

    args, cfg = parse_args(__doc__, argv)
    trainer = Stage2Trainer(cfg, seed=args.seed, use_wandb=not args.no_wandb,
                            config_path=args.config, device=args.device)
    trainer.train()
    print("Running finished...")


if __name__ == "__main__":
    main()
