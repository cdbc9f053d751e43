"""Checkpoints as PyTorch ``.pt`` files (counterpart of
``lns_tpu.train.checkpoint``).

Saves are atomic (written to ``path + ".tmp"``, then renamed). State dicts
carry the reference's key names, so the loaders read what the reference
trainers and ``lns_tpu.utils.torch_export`` write: a stage-1 autoencoder
(bare ``encoder.model...`` / ``quant_conv`` keys, ``export_autoencoder`` +
``save_torch_checkpoint``) and a stage-2 model (``vq_ae.`` / ``propagator.``
keys, ``export_latent_dynamics``), each loaded ``strict=True``. The JAX
package's flax msgpack and orbax formats are not read: a JAX-trained model
reaches the port through ``torch_export``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn


def save(obj: Any, path: str) -> None:
    """torch.save to `path`, atomically."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


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
    """Load a stage-2 ``model_*.pt`` (``vq_ae.`` and ``propagator.`` keys)
    into `model`, strictly."""
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    return model
