"""Checkpoints as PyTorch ``.pt`` files (counterpart of
``lns_tpu.train.checkpoint``).

Saves are atomic (written to ``path + ".tmp"``, then renamed). State dicts
carry the reference's key names, so the loaders read what the reference
trainers and ``lns_tpu.utils.torch_export`` write: a stage-1 autoencoder
(bare ``encoder.model...`` / ``quant_conv`` keys, ``export_autoencoder`` +
``save_torch_checkpoint``, or the port's stage-1 trainer) and a stage-2
model (``vq_ae.`` / ``propagator.`` keys, ``export_latent_dynamics``; the
conditional family's autoencoder under ``ae.``, as its reference trainer
names it), each loaded ``strict=True``. The JAX
package's flax msgpack and orbax formats are not read: a JAX-trained model
reaches the port through ``torch_export``.

A stage-1 run writes, per saved epoch (``tag`` an epoch number or
``final``), ``vqgan_epoch_{tag}.pt`` (the autoencoder, as the reference
names it), ``optim_epoch_{tag}.pt`` (the optimizer state) and
``meta_epoch_{tag}.json`` (the epoch to resume at, the seed, the best
validation so far), and ``vqgan_epoch_best.pt`` with ``meta_epoch_best.json``;
``stage1_sidecars`` finds the optimizer and meta files beside a model file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn


def save(obj: Any, path: str) -> None:
    """torch.save to `path`, atomically."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_json(obj: Any, path: str) -> None:
    """json.dump to `path`, atomically."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_stage1(ckpt_dir: str, tag, ae: nn.Module, meta: dict,
                optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """``vqgan_epoch_{tag}.pt``, ``meta_epoch_{tag}.json`` and, with an
    optimizer, ``optim_epoch_{tag}.pt`` in `ckpt_dir`."""
    save(state_dict_cpu(ae), os.path.join(ckpt_dir, f"vqgan_epoch_{tag}.pt"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(ckpt_dir, f"optim_epoch_{tag}.pt"))
    save_json(meta, os.path.join(ckpt_dir, f"meta_epoch_{tag}.json"))


def stage1_sidecars(model_path: str) -> Tuple[Optional[str], Optional[str]]:
    """(optimizer file, meta file) saved beside a ``vqgan_epoch_{tag}.pt``,
    each None where it does not exist (a reference checkpoint has neither)."""
    folder, name = os.path.split(model_path)
    stem = os.path.splitext(name)[0]
    if not stem.startswith("vqgan_epoch_"):
        return None, None
    optim = os.path.join(folder, "optim_" + stem[len("vqgan_"):] + ".pt")
    meta = os.path.join(folder, "meta_" + stem[len("vqgan_"):] + ".json")
    return (optim if os.path.exists(optim) else None, meta if os.path.exists(meta) else None)


def state_dict_cpu(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict, copied to the CPU (a checkpoint that loads
    on any device)."""
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` state dict (tensors only, ``weights_only``), on the CPU
    (``lns_tpu.utils.torch_compat.load_torch_state_dict``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items()}


def load_autoencoder_checkpoint(path: str, ae: nn.Module) -> nn.Module:
    """Load a stage-1 autoencoder ``.pt`` into `ae`, strictly."""
    ae.load_state_dict(load_torch_state_dict(path), strict=True)
    return ae


def load_latent_dynamics_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a stage-2 ``model_*.pt`` (``vq_ae.`` or, conditional, ``ae.``
    keys, and ``propagator.`` keys) into `model`, strictly."""
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    return model
