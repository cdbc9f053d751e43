"""Stage-2 training: the latent propagator trained by rollout BPTT in latent
space, the autoencoder frozen (counterpart of ``lns_tpu.train.stage2``;
mirrors the reference's TrainDynamics, train_stage2_ns2d.py).

A one-time encode pre-pass over the training corpus; Adam and the per-epoch
cosine schedule over the propagator's parameters only; the smooth-L1
rollout loss over ``out_tw`` steps; validation by the full-rollout
``LatentDynamics.predict`` with frame-wise and sequence-wise relative L2 on
denormalised fields. On the card the encode pre-pass and validation run the
hand-written kernels 1-3 under ``torch.no_grad``, and every train step's
GroupNorms launch kernel 3 through its autograd Function. The NS2d, SW,
two-phase and conditional two-phase families: the conditional family's
batches and validation trajectories carry each case's normalised
parameter, which conditions every rollout step.

Under a process group (``torchrun``; ``lns_tpu_torch.parallel``) the
trainer is data-parallel as the JAX package is on its mesh: each rank
trains on its rows of every global batch (``batch_size`` is the global
batch and divides by the world size), the loss module in
``DistributedDataParallel``, so each step launches the single-device
step's kernels plus the gradient all-reduce. The host path takes rank r's
``shard_rows`` of the global order; with ``device_data`` each rank keeps
its contiguous shard of the windows and gathers from it in the JAX
package's stratified order (``stratified_batches``). Each rank draws the
global batch's input noise and takes its rows, so a run over n ranks
trains on what one process would over the same global batches. Rank 0
alone makes the run directory, logs (the loss averaged over the ranks),
validates (the other ranks wait for its result) and writes checkpoints;
every rank loads a resume checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from torch import nn

from lns_tpu_torch.data import (ConditionalTankSloshingStage2, NS2DStage2, SWStage2,
                                TankSloshingStage2, epoch_batches, to_device)
from lns_tpu_torch.data.prefetch import prefetch_to_device
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.ops.losses import relative_lp_loss
from lns_tpu_torch.parallel import ddp
from lns_tpu_torch.train import checkpoint
from lns_tpu_torch.train.logging_utils import (MetricLogger, log_sequence, plot_error_curve,
                                               prepare_training)
from lns_tpu_torch.train.optim import stage2_optimizer
from lns_tpu_torch.train.stage1 import CHANNEL_NAMES

STAGE2_DATASETS = {"ns2d": NS2DStage2, "sw": SWStage2, "twophase": TankSloshingStage2,
                   "twophase_conditional": ConditionalTankSloshingStage2}


class RolloutLoss(nn.Module):
    """``LatentDynamics.rollout_loss`` as a module's forward: the module
    that ``DistributedDataParallel`` wraps (DDP arms its gradient
    all-reduce in ``forward``; ``LatentDynamics`` has none). The frozen
    autoencoder's parameters take no gradient, so DDP reduces the
    propagator's alone."""

    def __init__(self, model: LatentDynamics):
        super().__init__()
        self.model = model

    def forward(self, z_in: torch.Tensor, z_out: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.model.rollout_loss(z_in, z_out, cond)


@torch.no_grad()
def rollout_errors(model: LatentDynamics, val_ds, device, batch_size: int = 8,
                   decode_chunk: Optional[int] = None):
    """The full autoregressive rollout of `val_ds`'s held-out trajectories
    (the conditional family's each with its case's parameter), `batch_size`
    cases per ``predict``: frame-wise and sequence-wise relative L2 on
    denormalised fields (train_stage2_ns2d.py:238-293). Returns (frame
    errors [n, t, c], sequence errors [n, c], (prediction, ground truth) of
    the first batch, denormalised), numpy. ``Stage2Trainer.validate`` and
    ``lns_tpu_torch.cli.evaluate`` both score with it."""
    x0, y, *cond = val_ds.eval_trajectories()
    n, steps = y.shape[0], y.shape[1]
    frame_errs, seq_errs, first = [], [], None
    for i in range(0, n, batch_size):
        xb = torch.from_numpy(x0[i: i + batch_size, 0]).to(device)
        cb = torch.from_numpy(cond[0][i: i + batch_size]).to(device) if cond else None
        yhat = model.predict(xb, steps, cb, decode_chunk=decode_chunk)
        # denormalised in the prediction's dtype, as the JAX package does
        yhat_d = val_ds.denormalize(yhat).float()
        y_d = val_ds.denormalize(torch.from_numpy(y[i: i + batch_size]).to(device))
        # [b, t, h, w, c]: frame-wise over (h, w); sequence-wise over (t, h, w)
        frame_errs.append(relative_lp_loss(yhat_d, y_d, reduce_dim=(2, 3)))
        seq_errs.append(relative_lp_loss(yhat_d, y_d, reduce_dim=(1, 2, 3)))
        if first is None:
            first = (yhat_d.cpu().numpy(), y_d.cpu().numpy())
    return torch.cat(frame_errs).cpu().numpy(), torch.cat(seq_errs).cpu().numpy(), first


class Stage2Trainer:
    """Builds the model on `device` (the CUDA card when None; without CUDA
    it raises unless told ``device="cpu"``), initialises it from a
    ``torch.Generator`` seeded with `seed`, loads and freezes the pretrained
    autoencoder (``cfg.pretrained_checkpoint_path``, a stage-1 ``.pt``),
    encodes the training corpus, and resumes from ``cfg.resume_ckpt`` when
    ``cfg.resume_training`` is set.

    ``cfg.mixed_precision``: bf16 activations through the frozen AE and the
    rollout; parameters, optimizer and loss in f32. ``cfg.device_data``:
    the latent windows (and the conditional family's parameters) live on
    the device and batches are gathered there by index; otherwise each
    batch is copied from pinned host memory on a side stream ahead of its
    step (``prefetch_to_device``). ``cfg.async_checkpoint``: the ``.pt``
    files are written in the background. Under a process group the
    trainer is data-parallel (see the module's docstring); `device` is
    then this rank's (``ddp.init_from_env``)."""

    def __init__(self, cfg, seed: int = 1234, use_wandb: bool = True,
                 config_path: Optional[str] = None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Stage2Trainer: no CUDA device; pass device=\"cpu\" to train on "
                               "the CPU")
        self.cfg = cfg
        self.seed = seed
        self.rank, self.world = ddp.rank(), ddp.world_size()
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} (the global batch) does not divide "
                             f"over {self.world} ranks")
        self.logger = self.val_ds = None  # rank 0's
        ds_cls = STAGE2_DATASETS[cfg.workload]
        with ddp.main_first():  # rank 0 makes the run directory and the statistics files
            if ddp.is_main():
                prepare_training(cfg.log_dir, bool(cfg.overwrite_exist),
                                 config_path=config_path, config_dict=cfg.to_dict())
                self.logger = MetricLogger(cfg.log_dir, project=cfg.project_name,
                                           config=cfg.to_dict(), use_wandb=use_wandb)
                self.val_ds = ds_cls(cfg, train_mode=False)
            self.train_ds = ds_cls(cfg, train_mode=True)

        dt = torch.bfloat16 if cfg.mixed_precision else None
        self.model = init_weights_(LatentDynamics(cfg, dtype=dt, ae_dtype=dt, device=self.device),
                                   torch.Generator().manual_seed(seed))
        if cfg.pretrained_checkpoint_path:
            print(f"Loading pretrained autoencoder from {cfg.pretrained_checkpoint_path}")
            checkpoint.load_autoencoder_checkpoint(cfg.pretrained_checkpoint_path,
                                                   self.model.autoencoder)
            print("Pretrained autoencoder loaded successfully")
        self.model.autoencoder.requires_grad_(False).eval()  # frozen
        print(f"Number of parameters: {sum(p.numel() for p in self.model.propagator.parameters())}")

        self.device_data = bool(cfg.device_data)
        self.train_ds.encode_dataset(self.model.encode, self.device)
        self.steps_per_epoch = max(1, len(self.train_ds) // cfg.batch_size)
        self.opt, self.sched = stage2_optimizer(cfg, self.model.propagator.parameters(),
                                                self.steps_per_epoch)
        self.noise_level = float(cfg.noise_level or 0.0)
        self.start_epoch = 0
        # the lowest validation rollout error so far, saved as model_best
        self.best_val = float("inf")
        self.best_epoch = None
        self._ckptr = checkpoint.AsyncCheckpointer() if cfg.async_checkpoint else None
        self._save = self._ckptr.save if self._ckptr is not None else checkpoint.save
        if cfg.resume_training and cfg.resume_ckpt:
            self.load(cfg.resume_ckpt)
        self.loss_module = ddp.wrap(RolloutLoss(self.model), self.device)

    # ------------------------------------------------------------------
    def _noise_generator(self, epoch: int, step: int) -> torch.Generator:
        """A generator on the device seeded by (seed, epoch, step), like the
        data order: a resumed run draws the same noise."""
        seed = np.random.SeedSequence([self.seed, epoch, step]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed) >> 1)

    def train_step(self, z_in: torch.Tensor, z_out: torch.Tensor, epoch: int, step: int,
                   cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on this rank's rows of a global batch of
        windows (and, for the conditional family, their parameters `cond`
        [b]); returns the loss averaged over the ranks (a 0-d tensor on the
        device, not fetched)."""
        if self.noise_level > 0:  # the global batch's noise, this rank's rows
            g = self._noise_generator(epoch, step)
            noise = torch.randn((z_in.shape[0] * self.world,) + z_in.shape[1:], generator=g,
                                device=z_in.device, dtype=z_in.dtype)
            z_in = z_in + self.noise_level * ddp.shard_rows(noise, self.rank, self.world)
        loss = self.loss_module(z_in, z_out, cond)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.sched.step()
        return ddp.mean_over_ranks(loss.detach())

    def _batches(self, n: int, rng: np.random.Generator, windows):
        """This rank's rows of one epoch's global batches, on the device:
        (z_in, z_out) and the conditional family's parameters."""
        if self.device_data:  # gathered from this rank's shard of the windows
            for idx in ddp.stratified_batches(rng, n, self.cfg.batch_size, self.world):
                i = to_device(idx[self.rank], self.device)
                yield [a.index_select(0, i) for a in windows]
            return
        yield from prefetch_to_device(
            (self.train_ds.get_batch(ddp.shard_rows(idx, self.rank, self.world))
             for idx in epoch_batches(n, self.cfg.batch_size, rng, drop_last=True)), self.device)

    def train(self):
        cfg = self.cfg
        n = len(self.train_ds)
        windows = None
        if self.device_data:  # this rank's shard of the windows on the device
            windows = [to_device(a, self.device) for a in
                       self.train_ds.get_batch(ddp.corpus_shard(n, self.rank, self.world))]
        for epoch in range(self.start_epoch, cfg.epochs):
            # the data order is a function of (seed, epoch): a run resumed at
            # epoch k sees the batches a fresh run would
            rng = np.random.default_rng([self.seed, epoch])
            if epoch % cfg.ckpt_every == 0:
                self._checkpoint(epoch, epoch)
            for step, (z_in, z_out, *cond) in enumerate(self._batches(n, rng, windows)):
                loss = self.train_step(z_in, z_out, epoch, step, *cond)
                if self.logger is not None:
                    self.logger.log({"loss": loss})
        self._checkpoint(cfg.epochs, "final")
        if self._ckptr is not None:
            self._ckptr.wait()
        if self.logger is not None:
            self.logger.finish()

    def _checkpoint(self, epoch: int, tag) -> None:
        """Validate on rank 0 (the other ranks wait for its result), keep
        ``model_best`` on every rank's record, and save ``tag``'s files."""
        val = ddp.broadcast_scalar(self.validate(epoch) if ddp.is_main() else None)
        self._maybe_save_best(val, epoch)
        if ddp.is_main():
            self.save(tag)

    def _maybe_save_best(self, val: float, epoch) -> None:
        """Keep ``model_best``: the parameters with the lowest validation
        sequence rel-L2 so far (the reference saves every ckpt_every and
        leaves the pick to the user); written by rank 0."""
        if val >= self.best_val:
            return
        self.best_val, self.best_epoch = float(val), epoch
        if not ddp.is_main():
            return
        ckpt = os.path.join(self.cfg.log_dir, "checkpoints")
        self._save(checkpoint.state_dict_cpu(self.model), os.path.join(ckpt, "model_best.pt"))
        with open(os.path.join(ckpt, "meta_best.json"), "w") as f:
            json.dump({"epoch": int(epoch), "val_seq_rel_l2": self.best_val, "seed": self.seed}, f)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def validate(self, epoch, batch_size: int = 8) -> float:
        """Full autoregressive rollout of the validation cases: frame-wise
        and sequence-wise relative L2 on denormalised fields
        (train_stage2_ns2d.py:238-293), the conditional family's each with
        its case's parameter; returns the mean sequence-wise error, also
        logged as ``val_seq_rel_l2``. Rank 0's."""
        cfg = self.cfg
        frame_err, seq_err, (sample_pred, sample_gt) = rollout_errors(
            self.model, self.val_ds, self.device, batch_size, cfg.decode_chunk)
        steps = frame_err.shape[1]
        seq_mean = seq_err.mean(axis=0)  # [c]
        print(f"Averaged sequence-wise relative loss: {seq_mean}")
        val = float(seq_mean.mean())
        metrics = {"val_seq_rel_l2": val}
        names = CHANNEL_NAMES[cfg.workload]
        if len(names) > 1:  # per-channel losses (train_stage2_SW.py:264-287)
            for c, name in enumerate(names):
                print(f"Averaged sequence-wise relative loss on {name}: {seq_mean[c]}")
                metrics[f"val_pred_loss_{name}"] = float(seq_mean[c])
        self.logger.log(metrics)

        sdir = os.path.join(cfg.log_dir, "samples")
        stride, nshow = max(1, steps // 6), min(4, sample_pred.shape[0])
        if len(names) > 1:  # and a sample / gt grid per channel
            for c, name in enumerate(names):
                spath_c = os.path.join(sdir, f"sample_{name}_{epoch}.png")
                log_sequence(sample_pred[:nshow, ::stride, :, :, c], spath_c)
                log_sequence(sample_gt[:nshow, ::stride, :, :, c],
                             os.path.join(sdir, f"gt_{name}_{epoch}.png"))
                self.logger.log_image(f"sample_{name}", spath_c)
        spath = os.path.join(sdir, f"sample_{epoch}.png")
        log_sequence(sample_pred[:nshow, ::stride, :, :, 0], spath)
        log_sequence(sample_gt[:nshow, ::stride, :, :, 0], os.path.join(sdir, f"gt_{epoch}.png"))
        cpath = os.path.join(sdir, f"err_curve_{epoch}.png")
        plot_error_curve(frame_err.mean(axis=(0, 2)), frame_err.std(axis=0).mean(-1), cpath)
        self.logger.log_image("val_error_curve", cpath)
        self.logger.log_image("sample", spath)
        return val

    def save(self, epoch) -> None:
        """``model_{epoch}.pt`` (the ``vq_ae.`` (conditional: ``ae.``) /
        ``propagator.`` state dict),
        ``optim_{epoch}.pt`` (optimizer and schedule) and
        ``meta_{epoch}.json`` (the epoch to resume at, seed, best so far)."""
        ckpt = os.path.join(self.cfg.log_dir, "checkpoints")
        self._save(checkpoint.state_dict_cpu(self.model), os.path.join(ckpt, f"model_{epoch}.pt"))
        self._save({"optimizer": self.opt.state_dict(), "scheduler": self.sched.state_dict()},
                   os.path.join(ckpt, f"optim_{epoch}.pt"))
        with open(os.path.join(ckpt, f"meta_{epoch}.json"), "w") as f:
            json.dump({"epoch": self.cfg.epochs if epoch == "final" else int(epoch),
                       "seed": self.seed,
                       "best_val": None if self.best_val == float("inf") else self.best_val,
                       "best_epoch": self.best_epoch}, f)

    def load(self, model_path: str) -> None:
        """Resume from ``model_{k}.pt``: the parameters, then (when beside
        it) ``optim_{k}.pt``'s optimizer and schedule state and
        ``meta_{k}.json``'s epoch, seed and best validation, so ``train``
        continues at epoch k as the run that saved it would have."""
        checkpoint.load_latent_dynamics_checkpoint(model_path, self.model)
        folder, name = os.path.split(model_path)
        stem = os.path.splitext(name)[0]
        optim_path = os.path.join(folder, stem.replace("model_", "optim_", 1) + ".pt")
        if optim_path != model_path and os.path.exists(optim_path):
            state = torch.load(optim_path, map_location="cpu", weights_only=True)
            self.opt.load_state_dict(state["optimizer"])
            self.sched.load_state_dict(state["scheduler"])
        meta_path = os.path.join(folder, stem.replace("model_", "meta_", 1) + ".json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.start_epoch = int(meta["epoch"])
            self.seed = int(meta.get("seed", self.seed))
            if meta.get("best_val") is not None:  # a resumed run keeps the best so far
                self.best_val = float(meta["best_val"])
                self.best_epoch = meta.get("best_epoch")
