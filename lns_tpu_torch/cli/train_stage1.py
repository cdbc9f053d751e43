"""Stage-1 training entry point (NS2d, SW and the two-phase families, e.g.
configs/SW_stage1_ae.yml):

    python -m lns_tpu_torch.cli.train_stage1 --config configs/ns2d_stage1_ae.yml

Trains the autoencoder on the CUDA card unless given ``--device cpu``. The
config is YAML (PyYAML needed); without it, build a ``Config`` in code and
call ``lns_tpu_torch.train.stage1.Stage1Trainer`` directly.

Data-parallel over N devices (the batch_size in the config is the global
batch; each process trains on one device, NCCL on the cards, gloo with
``--device cpu``):

    torchrun --nproc_per_node N -m lns_tpu_torch.cli.train_stage1 --config <yml>
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    from lns_tpu_torch.cli.common import run_trainer
    from lns_tpu_torch.train.stage1 import Stage1Trainer

    run_trainer(Stage1Trainer, __doc__, argv)


if __name__ == "__main__":
    main()
