"""Rollout evaluation of a stage-2 checkpoint (counterpart of
``lns_tpu.cli.evaluate``): load it and report frame-wise and sequence-wise
relative L2 over the full autoregressive rollout of the held-out split.

    python -m lns_tpu_torch.cli.evaluate --config configs/ns2d_stage2_prop.yml \\
        --checkpoint experiments/.../checkpoints/model_best.pt [--out metrics.json]

The checkpoint is a ``.pt`` (the port's ``model_*.pt`` or the reference's /
``torch_export``'s state dict) or the JAX package's flax ``.msgpack``. It
runs on the CUDA card unless given ``--device cpu``, the predict on kernels
1-3, in the activation dtype the trainer uses (bf16 under
``mixed_precision``; the JAX package's evaluate runs f32 whatever the
config), so a port checkpoint scores as the trainer's validation did. The
metrics JSON has the JAX package's keys, with ``training_best_checkpoint``
from a ``meta_best.json`` beside the checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch


def load_model(cfg, path: str, device=None):
    """``LatentDynamics(cfg)`` on `device` (the card when None) with the
    parameters of the checkpoint at `path` (``.pt`` or flax ``.msgpack``),
    loaded strictly."""
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.train import checkpoint
    from lns_tpu_torch.utils.msgpack import unpackb
    from lns_tpu_torch.utils.convert import state_dict_from_jax

    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package's "
                         "async saves); give a .pt or a .msgpack file")
    dt = torch.bfloat16 if cfg.mixed_precision else None
    model = LatentDynamics(cfg, dtype=dt, ae_dtype=dt, device=device)
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            state = state_dict_from_jax(cfg, unpackb(f.read()))
    else:
        state = checkpoint.load_torch_state_dict(path)
    model.load_state_dict(state, strict=True)
    return model.eval()


def evaluate_model(model, val_ds, device, batch_size: int = 8,
                   decode_chunk: Optional[int] = None) -> dict:
    """The rollout metrics of `model` on `val_ds`'s trajectories
    (``rollout_errors``, the per-batch scoring of ``Stage2Trainer.
    validate``); ``seq_rel_l2`` is the mean of the per-channel means, the
    trainer's ``val_seq_rel_l2``."""
    from lns_tpu_torch.train.stage2 import rollout_errors

    frame_err, seq_err, _ = rollout_errors(model, val_ds, device, batch_size, decode_chunk)
    per_channel = seq_err.mean(axis=0)
    return {"rollout_steps": int(frame_err.shape[1]), "num_trajectories": int(seq_err.shape[0]),
            "seq_rel_l2_per_channel": per_channel.tolist(),
            "seq_rel_l2": float(per_channel.mean()),
            "frame_rel_l2_vs_time": frame_err.mean(axis=(0, 2)).tolist()}


def evaluate_checkpoint(cfg, path: str, batch_size: int = 8, decode_chunk: Optional[int] = None,
                        device=None) -> dict:
    """Load the checkpoint at `path` and score it on the config's held-out
    split (``decode_chunk`` defaults to the config's); adds the training
    run's ``meta_best.json`` record when one lies beside the checkpoint."""
    from lns_tpu_torch.train.stage2 import STAGE2_DATASETS

    device = torch.device("cuda" if device is None else device)
    model = load_model(cfg, path, device)
    val_ds = STAGE2_DATASETS[cfg.workload](cfg, train_mode=False)
    dc = decode_chunk if decode_chunk is not None else cfg.decode_chunk
    metrics = evaluate_model(model, val_ds, device, batch_size, dc)
    best = os.path.join(os.path.dirname(path), "meta_best.json")
    if os.path.exists(best):
        with open(best) as f:
            metrics["training_best_checkpoint"] = json.load(f)
    return metrics


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from lns_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="stage-2 model checkpoint (.pt or the JAX package's .msgpack)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--decode-chunk", type=int, default=None,
                   help="decode the rollout's frames this many at a time (default: the "
                        "config's decode_chunk; all at once when it has none)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    p.add_argument("--out", type=str, default=None, help="write the metrics JSON here")
    args = p.parse_args(argv)
    metrics = evaluate_checkpoint(load_config(args.config), args.checkpoint, args.batch_size,
                                  args.decode_chunk, args.device)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
