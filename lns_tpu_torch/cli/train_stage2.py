"""Stage-2 training entry point (NS2d, SW, two-phase and conditional two-phase, e.g.
configs/SW_stage2_prop.yml or configs/twophase_stage2_cond_prop.yml):

    python -m lns_tpu_torch.cli.train_stage2 --config configs/ns2d_stage2_prop.yml

Trains on the CUDA card unless given ``--device cpu``. The config is YAML
(PyYAML needed); without it, build a ``Config`` in code and call
``lns_tpu_torch.train.stage2.Stage2Trainer`` directly.

Data-parallel over N devices (the batch_size in the config is the global
batch; each process trains on one device, NCCL on the cards, gloo with
``--device cpu``):

    torchrun --nproc_per_node N -m lns_tpu_torch.cli.train_stage2 --config <yml>
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    from lns_tpu_torch.cli.common import run_trainer
    from lns_tpu_torch.train.stage2 import Stage2Trainer

    run_trainer(Stage2Trainer, __doc__, argv)


if __name__ == "__main__":
    main()
