"""Stage-1 training: the autoencoder trained to reconstruct single frames
with the relative-L2 loss (counterpart of ``lns_tpu.train.stage1``;
mirrors the reference's TrainAE, train_stage1_ns2d.py).

Adam over every AE parameter (``stage1_optimizer``); the loss is
``relative_lp_loss`` over the spatial dims with ``reduce_all``, in f32;
validation and checkpoints every ``ckpt_every`` epochs, validation as the
per-frame reconstruction rel-L2 on denormalised held-out trajectories. On
the card every train step differentiates through the hand-written kernels
2 and 3 (kernel 4 where the encoder has a d-space FAB) by their autograd
Functions, and validation runs them under ``torch.no_grad``. The NS2d, SW,
two-phase and conditional two-phase families (the last trains the plain
two-phase autoencoder: its conditioning is the propagator's); the two-phase
loss is taken on denormalised fields (train_stage1_twophase.py:71-73).

Under a process group (``torchrun``) the trainer is data-parallel by the
stage-2 trainer's rules (``lns_tpu_torch.train.stage2``): the autoencoder
itself in ``DistributedDataParallel`` (every parameter takes a gradient),
rank r's rows of each global batch, rank 0 alone logging, validating and
saving. As the JAX package on a mesh, the host path then drops the last
partial batch of an epoch (``drop_last=True``), which one process keeps,
and with ``device_data`` each rank gathers from its own shard of the
frames in the stratified order.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lns_tpu_torch.data import (NS2DStage1, SWStage1, TankSloshingStage1, epoch_batches,
                                to_device)
from lns_tpu_torch.data.prefetch import prefetch_to_device
from lns_tpu_torch.models import SimpleAutoencoder
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.ops.losses import relative_lp_loss
from lns_tpu_torch.parallel import ddp
from lns_tpu_torch.train import checkpoint
from lns_tpu_torch.train.logging_utils import (MetricLogger, log_sequence, plot_error_curve,
                                               prepare_training)
from lns_tpu_torch.train.optim import stage1_optimizer

STAGE1_DATASETS = {"ns2d": NS2DStage1, "sw": SWStage1, "twophase": TankSloshingStage1,
                   "twophase_conditional": TankSloshingStage1}

# per-workload field channel names, in the dataset's channel order
# (reference: train_stage1_SW.py:119-131 logs vx / vy / prs losses;
# train_stage1_twophase.py prints vx / vy / pressure / vof)
CHANNEL_NAMES = {"ns2d": ("vorticity",), "sw": ("vx", "vy", "prs"),
                 "twophase": ("vx", "vy", "prs", "vof"),
                 "twophase_conditional": ("vx", "vy", "prs", "vof")}


def reconstruction_loss(model, x: torch.Tensor, denormalize=None) -> torch.Tensor:
    """The stage-1 loss of `model` on frames x [b, H, W, C] (f32): the
    relative L2 of the reconstruction over (H, W) per sample and channel,
    averaged; computed in f32 whatever the activation dtype. With
    `denormalize` (the two-phase family) both fields are denormalised
    first."""
    x_hat = model(x).float()
    if denormalize is not None:
        x_hat, x = denormalize(x_hat), denormalize(x)
    return relative_lp_loss(x_hat, x, reduce_dim=(1, 2), p=2, reduce_all=True)


class Stage1Trainer:
    """Builds the autoencoder on `device` (the CUDA card when None; without
    CUDA it raises unless told ``device="cpu"``), initialises it from a
    ``torch.Generator`` seeded with `seed`, and resumes from
    ``cfg.resume_ckpt`` when ``cfg.resume_training`` is set.

    ``cfg.mixed_precision``: bf16 activations; parameters, optimizer and
    loss in f32. ``cfg.device_data``: the training frames live on the
    device and batches are gathered there by index; otherwise each batch is
    copied from pinned host memory on a side stream ahead of its step
    (``prefetch_to_device``). ``cfg.async_checkpoint``: the ``.pt`` files
    are written in the background. Under a process group the trainer is
    data-parallel (see the module's docstring); `device` is then this
    rank's (``ddp.init_from_env``)."""

    def __init__(self, cfg, seed: int = 1234, use_wandb: bool = True,
                 config_path: Optional[str] = None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Stage1Trainer: no CUDA device; pass device=\"cpu\" to train on "
                               "the CPU")
        self.cfg = cfg
        self.seed = seed
        self.rank, self.world = ddp.rank(), ddp.world_size()
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} (the global batch) does not divide "
                             f"over {self.world} ranks")
        self.logger = self.val_ds = None  # rank 0's
        ds_cls = STAGE1_DATASETS[cfg.workload]
        with ddp.main_first():  # rank 0 makes the run directory and the statistics files
            if ddp.is_main():
                prepare_training(cfg.log_dir, bool(cfg.overwrite_exist),
                                 config_path=config_path, config_dict=cfg.to_dict())
                self.logger = MetricLogger(cfg.log_dir, project=cfg.project_name,
                                           config=cfg.to_dict(), use_wandb=use_wandb)
                self.val_ds = ds_cls(cfg, train_mode=False)
            self.train_ds = ds_cls(cfg, train_mode=True)
        # the two-phase families take their loss on denormalised fields
        self._loss_denorm = (self.train_ds.denormalize if cfg.workload.startswith("twophase")
                             else None)
        with self.device:  # the parameters are allocated there
            self.model = SimpleAutoencoder(
                cfg, dtype=torch.bfloat16 if cfg.mixed_precision else None)
        init_weights_(self.model, torch.Generator().manual_seed(seed))
        self.opt = stage1_optimizer(cfg, self.model.parameters())
        self.device_data = bool(cfg.device_data)
        self.start_epoch = 0
        # the lowest validation reconstruction rel-L2 so far, saved as
        # vqgan_epoch_best (the reference saves every ckpt_every only)
        self.best_val = float("inf")
        self.best_epoch = None
        self._ckptr = checkpoint.AsyncCheckpointer() if cfg.async_checkpoint else None
        self._save = self._ckptr.save if self._ckptr is not None else checkpoint.save
        if cfg.resume_training and cfg.resume_ckpt:
            self.load(cfg.resume_ckpt)
        # reconstruction_loss calls the module: DDP wraps the autoencoder itself
        self.ddp_model = ddp.wrap(self.model, self.device)
        print(f"Number of trainable parameters: {sum(p.numel() for p in self.model.parameters())}")

    # ------------------------------------------------------------------
    def _loss(self, x: torch.Tensor) -> torch.Tensor:
        return reconstruction_loss(self.ddp_model, x, self._loss_denorm)

    def train_step(self, x: torch.Tensor) -> torch.Tensor:
        """One optimizer step on this rank's rows of a global batch of
        frames; returns the loss averaged over the ranks (a 0-d tensor on
        the device, not fetched)."""
        loss = self._loss(x)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return ddp.mean_over_ranks(loss.detach())

    def _batches(self, n: int, rng: np.random.Generator, frames):
        """This rank's rows of one epoch's global batches of frames, on the
        device. One process keeps an epoch's last partial batch; on several
        ranks it is dropped and a device corpus is gathered per shard in the
        stratified order, as the JAX package's mesh does."""
        if self.device_data:
            if self.world > 1:
                order = (idx[self.rank] for idx in
                         ddp.stratified_batches(rng, n, self.cfg.batch_size, self.world))
            else:
                order = epoch_batches(n, self.cfg.batch_size, rng, drop_last=False)
            for idx in order:
                yield frames.index_select(0, to_device(idx, self.device))
            return
        for (x,) in prefetch_to_device(
                ((self.train_ds.get_batch(ddp.shard_rows(idx, self.rank, self.world)),)
                 for idx in epoch_batches(n, self.cfg.batch_size, rng,
                                          drop_last=self.world > 1)), self.device):
            yield x

    def train(self):
        cfg = self.cfg
        n = len(self.train_ds)
        frames = None
        if self.device_data:  # this rank's shard of the frames on the device
            frames = to_device(self.train_ds.get_batch(ddp.corpus_shard(n, self.rank, self.world)),
                               self.device)
        for epoch in range(self.start_epoch, cfg.epochs):
            # the data order is a function of (seed, epoch): a run resumed at
            # epoch k sees the batches a fresh run would
            rng = np.random.default_rng([self.seed, epoch])
            if epoch % cfg.ckpt_every == 0:
                self._checkpoint(epoch, epoch)
            for x in self._batches(n, rng, frames):
                loss = self.train_step(x)
                if self.logger is not None:
                    self.logger.log({"rec_loss": loss})
        self._checkpoint("final", "final")
        if self._ckptr is not None:
            self._ckptr.wait()
        if self.logger is not None:
            self.logger.finish()

    def _checkpoint(self, epoch, tag) -> None:
        """Validate on rank 0 (the other ranks wait for its result), keep
        ``vqgan_epoch_best`` on every rank's record, and save ``tag``'s
        files."""
        val = ddp.broadcast_scalar(self.validate(epoch) if ddp.is_main() else None)
        self._maybe_save_best(val, epoch)
        if ddp.is_main():
            self.save(tag)

    def _maybe_save_best(self, val: float, epoch) -> None:
        """Keep ``vqgan_epoch_best``: the AE with the lowest validation
        reconstruction rel-L2 so far; written by rank 0."""
        if val >= self.best_val:
            return
        self.best_val, self.best_epoch = float(val), epoch
        if not ddp.is_main():
            return
        checkpoint.save_stage1(os.path.join(self.cfg.log_dir, "checkpoints"), "best", self.model,
                               {"epoch": self._next_epoch(epoch), "val_recon_loss": self.best_val,
                                "seed": self.seed}, writer=self._save)

    def _next_epoch(self, epoch) -> int:
        return self.cfg.epochs if epoch == "final" else int(epoch)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, frames: np.ndarray, batch: int = 64) -> torch.Tensor:
        """The AE's reconstruction of frames [N, H, W, C] (numpy, f32), on
        the device in the activation dtype; `batch` frames per call, the
        last call padded with repeats of its last frame, as the JAX
        package's validation does."""
        outs = []
        bs = min(batch, frames.shape[0])
        for i in range(0, frames.shape[0], bs):
            chunk = frames[i: i + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            y = self.model(to_device(chunk, self.device))
            outs.append(y[: bs - pad])
        return torch.cat(outs)

    def validate(self, epoch) -> float:
        """Per-frame reconstruction rel-L2 on denormalised held-out
        trajectories (train_stage1_ns2d.py:99-148); returns its mean, also
        logged as ``val_recon_loss``. Rank 0's."""
        cfg = self.cfg
        traj = self.val_ds.eval_trajectories()  # [n, t, h, w, c]
        nc, t = traj.shape[:2]
        recon = self.reconstruct(traj.reshape(nc * t, *traj.shape[2:])).reshape(traj.shape)
        # denormalised in the reconstruction's dtype, as the JAX package does
        recon_d = self.val_ds.denormalize(recon).float()
        traj_d = self.val_ds.denormalize(torch.from_numpy(traj).to(self.device))
        # [n, t, h, w, c] -> rel-L2 over (h, w) -> [n, t, c]
        err = relative_lp_loss(recon_d, traj_d, reduce_dim=(2, 3), p=2).cpu().numpy()
        val = float(err.mean())
        print(f"Validation Reconstruction Loss: {val}")
        metrics = {"val_recon_loss": val}
        names = CHANNEL_NAMES[cfg.workload]
        per_ch = err.mean(axis=(0, 1))  # [c]
        if len(names) > 1:  # per-channel losses (train_stage1_SW.py:119-131)
            for c, name in enumerate(names):
                print(f"Validation Reconstruction Loss on {name}: {per_ch[c]}")
                metrics[f"val_recon_loss_{name}"] = float(per_ch[c])
        self.logger.log(metrics)

        sdir = os.path.join(cfg.log_dir, "samples")
        stride, nshow = max(1, t // 6), min(4, nc)
        # a sample / gt grid per channel where there are several
        for c, name in enumerate(names):
            sfx = f"_{name}" if len(names) > 1 else ""
            spath = os.path.join(sdir, f"sample{sfx}_{epoch}.png")
            log_sequence(recon_d[:nshow, ::stride, :, :, c].cpu().numpy(), spath)
            log_sequence(traj_d[:nshow, ::stride, :, :, c].cpu().numpy(),
                         os.path.join(sdir, f"gt{sfx}_{epoch}.png"))
            self.logger.log_image(f"sample{sfx}", spath)
        cpath = os.path.join(sdir, f"err_curve_{epoch}.png")
        plot_error_curve(err.mean(axis=(0, 2)), err.std(axis=0).mean(-1), cpath)
        self.logger.log_image("val_error_curve", cpath)
        return val

    def save(self, epoch) -> None:
        """``vqgan_epoch_{epoch}.pt`` (the AE's state dict, the reference's
        keys), ``optim_epoch_{epoch}.pt`` and ``meta_epoch_{epoch}.json``
        (the epoch to resume at, seed, best so far)."""
        checkpoint.save_stage1(
            os.path.join(self.cfg.log_dir, "checkpoints"), epoch, self.model,
            {"epoch": self._next_epoch(epoch), "seed": self.seed,
             "best_val": None if self.best_val == float("inf") else self.best_val,
             "best_epoch": self.best_epoch}, self.opt, writer=self._save)

    def load(self, model_path: str) -> None:
        """Resume from ``vqgan_epoch_{k}.pt`` (or start from any stage-1
        ``.pt``): the parameters, then, when beside it, the optimizer state
        of ``optim_epoch_{k}.pt`` and the epoch, seed and best validation of
        ``meta_epoch_{k}.json``, so ``train`` continues at epoch k with the
        batch order of the run that saved it. (The JAX trainer resets its
        best validation after loading; this one keeps the saved one, so a
        resumed run does not overwrite a better ``vqgan_epoch_best``.)"""
        checkpoint.load_autoencoder_checkpoint(model_path, self.model)
        optim_path, meta_path = checkpoint.stage1_sidecars(model_path)
        if optim_path is not None:
            self.opt.load_state_dict(torch.load(optim_path, map_location="cpu",
                                                weights_only=True))
        if meta_path is not None:
            meta = checkpoint.load_json(meta_path)
            self.start_epoch = int(meta["epoch"])
            self.seed = int(meta.get("seed", self.seed))
            if meta.get("best_val") is not None:
                self.best_val = float(meta["best_val"])
                self.best_epoch = meta.get("best_epoch")
