"""Checkpoints as PyTorch ``.pt`` files (counterpart of
``lns_tpu.train.checkpoint``).

Saves are atomic (written to ``path + ".tmp"``, then renamed). State dicts
carry the reference's key names, so the loaders read what the reference
trainers and ``lns_tpu.utils.torch_export`` write: a stage-1 autoencoder
(bare ``encoder.model...`` / ``quant_conv`` keys, ``export_autoencoder`` +
``save_torch_checkpoint``, or the port's stage-1 trainer) and a stage-2
model (``vq_ae.`` / ``propagator.`` keys, ``export_latent_dynamics``; the
conditional family's autoencoder under ``ae.``, as its reference trainer
names it), each loaded ``strict=True``. A JAX-trained flax ``.msgpack``
reaches the port through ``lns_tpu_torch.cli.convert`` (or is read
directly by ``lns_tpu_torch.cli.evaluate``); the JAX package's orbax
directories are not read. ``AsyncCheckpointer`` writes in the background
(``cfg.async_checkpoint``).

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
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn


def save(obj: Any, path: str) -> None:
    """torch.save to `path`, atomically."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_copy(obj: Any) -> Any:
    """`obj` (tensors in dicts, lists and tuples) with every tensor copied
    to the CPU, so later in-place updates do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Background saves (counterpart of ``lns_tpu.train.checkpoint.
    AsyncCheckpointer``): ``save`` copies the object's tensors to the CPU,
    then one worker thread writes them with ``save`` (atomically) while
    training goes on. ``wait`` blocks until every save queued so far is on
    disk and raises the first save's error, if any."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def save(self, obj: Any, path: str) -> None:
        self._pending.append(self._pool.submit(save, _cpu_copy(obj), path))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()


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
                optimizer: Optional[torch.optim.Optimizer] = None, writer=save) -> None:
    """``vqgan_epoch_{tag}.pt``, ``meta_epoch_{tag}.json`` and, with an
    optimizer, ``optim_epoch_{tag}.pt`` in `ckpt_dir`; the ``.pt`` files
    through `writer` (``save``, or an ``AsyncCheckpointer``'s)."""
    writer(state_dict_cpu(ae), os.path.join(ckpt_dir, f"vqgan_epoch_{tag}.pt"))
    if optimizer is not None:
        writer(optimizer.state_dict(), os.path.join(ckpt_dir, f"optim_epoch_{tag}.pt"))
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
