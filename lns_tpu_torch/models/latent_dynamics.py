"""Latent dynamics: a frozen autoencoder and a latent propagator, with the
stage-2 training rollout and the fused inference rollout (counterpart of
``lns_tpu.models.latent_dynamics``).

``rollout_loss`` feeds the propagator its own predictions ``t_out`` times
with full backpropagation through time, as the JAX package's training scan
does; it runs the module step, never the fused rollout kernel, and on the
card its GroupNorms launch kernel 3 through its autograd Function.

``predict`` encodes once, runs every propagator step, then decodes the
(batch x steps) latents in chunks. While spans record
(``utils.profiling``: under a ``torch.profiler`` or ``recording()``) it
opens one at each layer boundary: ``lns.predict`` (the root: batch, steps,
to_x, decode_chunk, and every counter's change over the predict) over
``lns.encode`` (frames), ``lns.propagate`` (the cast of the carry, and
``lns.pack`` and ``lns.rollout`` (steps, path "kernel" or "loop"; on the
kernel path the wrapper adds plan and samples_per_block) inside it, the
transpose) and one ``lns.decode`` (frames; its ``nth`` the chunk's
index) per decode call; a conditional model's predict opens
``lns.conditioning`` (batch) before ``lns.encode``. ``predict_latents``
called alone is a predict of its own. The counter ``LOOP_STEPS`` (always
on) adds the batch for each step the loop path takes: B x steps a predict
there, 0 where kernel 1 ran. On a CUDA device the steps run as one
launch of the rollout kernel (``kernels.prop_rollout``): a conditional
propagator's through its FiLM plan (``fused_cond_rollout``, ``plan="film"``
on ``lns.rollout``) where its carry is bf16 at a shape that plan takes
(``film_takes``: C 128, C_lat 64, H W <= 128, zero padding), as modules
otherwise (f32, the CPU, another shape); with
``use_kernels(False)`` every kernel of the model is replaced by its plain
PyTorch version, on any device. Parameters live under ``vq_ae`` and
``propagator``, the reference trainer's state-dict names (``ae`` and
``propagator`` for the conditional family, as its trainer names them). The
model is built on the card unless the caller names another device
(``device="cpu"``).

A conditional model (``cfg.is_conditional``: a ``CondSimpleCNN``) takes
each sample's parameter ``cond`` [b] in ``propagate``, ``rollout_loss``,
``predict_latents`` and ``predict``; every other model takes none. Its
conditioning (the embedding, its MLP, each block's projection and FiLM
scale) depends on ``cond`` alone, so a rollout computes it once and each
step reuses it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lns_tpu_torch.kernels.prop_rollout import (cond_terms, film_takes, fused_cond_rollout,
                                                 fused_rollout, pack_cond_simple_cnn,
                                                 pack_simple_cnn)
from lns_tpu_torch.models.autoencoder import SimpleAutoencoder
from lns_tpu_torch.models.propagator import build_propagator
from lns_tpu_torch.ops.losses import smooth_l1_loss
from lns_tpu_torch.utils import profiling

LOOP_STEPS = "latent_dynamics.loop_steps"  # samples stepped by the module loop


class LatentDynamics(nn.Module):
    """Autoencoder (``vq_ae``; ``ae`` when conditional) + propagator; NHWC
    in and out."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 ae_dtype: Optional[torch.dtype] = None, device=None):
        """Parameters are built on `device`: the CUDA card when None."""
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LatentDynamics: no CUDA device; pass device=\"cpu\" to build "
                               "the model on the CPU")
        self.cfg = cfg
        self.dtype = dtype
        self.conditional = cfg.is_conditional
        # the reference's conditional trainer names its autoencoder `ae`
        # (lns_tpu/utils/torch_export.py: export_latent_dynamics)
        self.ae_name = "ae" if self.conditional else "vq_ae"
        with device:  # the submodules' parameters are allocated there
            self.add_module(self.ae_name, SimpleAutoencoder(cfg, dtype=ae_dtype))
            self.propagator = build_propagator(cfg, dtype=dtype)
        self.use_kernel = True

    @property
    def autoencoder(self) -> SimpleAutoencoder:
        """The frozen autoencoder (``vq_ae``, or ``ae`` when conditional)."""
        return getattr(self, self.ae_name)

    def use_kernels(self, flag: bool) -> "LatentDynamics":
        """Route every kernel of the model (rollout, FAB core, GroupNorm)
        through its kernel (True) or its plain version (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = flag
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("lns.encode", frames=x.shape[0]):
            return self.autoencoder.encode(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with profiling.span("lns.decode", frames=z.shape[0]):
            return self.autoencoder.decode(z)

    def conditioning(self, cond: Optional[torch.Tensor]):
        """What a conditional propagator's steps share (``CondSimpleCNN.
        conditioning``), None for any other; raises unless `cond` is given
        exactly when the model is conditional."""
        if self.conditional and cond is None:
            raise ValueError("a conditional model (cond_channels) takes each sample's "
                             "parameter: pass cond [b]")
        if not self.conditional and cond is not None:
            raise ValueError("cond given to a model that is not conditional (no cond_channels "
                             "in its config)")
        return self.propagator.conditioning(cond) if self.conditional else None

    def _step(self, z: torch.Tensor, shared) -> torch.Tensor:
        """One propagator step, given ``conditioning``'s result."""
        return self.propagator.step(z, shared) if self.conditional else self.propagator(z)

    def propagate(self, z: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._step(z, self.conditioning(cond))

    def rollout_loss(self, z_in: torch.Tensor, z_out: torch.Tensor,
                     cond: Optional[torch.Tensor] = None, loss_fn=smooth_l1_loss,
                     remat: Optional[bool] = None) -> torch.Tensor:
        """The stage-2 training loss (reference train_stage2_ns2d.py:126-141):
        the propagator fed its own prediction ``t_out`` times, the loss of
        the stacked predictions against the latent targets, in f32.

        z_in [b, 1, h, w, c], z_out [b, t_out, h, w, c], cond [b] for a
        conditional model (its conditioning computed once). The carry is cast to
        the propagator's dtype when it has one. With `remat` (else
        ``cfg.remat``) each step is recomputed in the backward pass
        (``torch.utils.checkpoint``), which trades one more forward per
        step for activation memory that does not grow with ``t_out``."""
        shared = self.conditioning(cond)  # once; autograd sums its gradient over the steps
        z = z_in[:, 0]  # only the time axis: a batch of 1 stays a batch
        if self.dtype is not None:
            z = z.to(self.dtype)
        use_remat = bool(self.cfg.remat) if remat is None else remat
        preds = []
        for _ in range(z_out.shape[1]):
            z = checkpoint(self._step, z, shared, use_reentrant=False) if use_remat \
                else self._step(z, shared)
            preds.append(z)
        return loss_fn(torch.stack(preds, dim=1).float(), z_out.float())

    @torch.no_grad()
    def predict_latents(self, x: torch.Tensor, steps: int,
                        cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode once, roll the propagator `steps` times:
        x [b, H, W, c] -> [b, steps, h, w, latent_dim]; cond [b] for a
        conditional model."""
        with profiling.span("lns.predict", root=True, batch=x.shape[0], steps=steps,
                            to_x=False, decode_chunk=None):
            return self._latents(x, steps, cond)

    def _latents(self, x: torch.Tensor, steps: int, cond: Optional[torch.Tensor]) -> torch.Tensor:
        """``predict_latents`` inside a predict's span."""
        with (profiling.span("lns.conditioning", batch=x.shape[0]) if self.conditional
              else contextlib.nullcontext()):
            shared = self.conditioning(cond)
        z = self.encode(x)
        with profiling.span("lns.propagate", steps=steps):
            if self.dtype is not None:
                z = z.to(self.dtype)  # the carry is in the propagator's dtype
            p = self.propagator
            # a conditional propagator whose carry takes kernel 1's FiLM plan
            # (a CUDA bf16 carry at a shape its C limit takes) runs every
            # step in one launch; any other (the CPU, f32, another shape)
            # steps as modules, as the JAX package does for every
            # conditional propagator (lns_tpu/models/latent_dynamics.py:
            # _pallas_rollout_ok)
            if self.use_kernel and self.conditional and film_takes(
                    z, p.in_proj.weight.shape[0], p.padding_mode):
                with profiling.span("lns.pack"):
                    packed = pack_cond_simple_cnn(p, z.dtype)
                    e, c = cond_terms(shared)
                with profiling.span("lns.rollout", steps=steps, path="kernel"):
                    zs = fused_cond_rollout(z, packed, e, c, steps, p.prop_n_block, p.dilation,
                                            p.padding_mode)
                return zs.transpose(0, 1)
            if self.use_kernel and not self.conditional:
                # every padding mode, zeros too: the JAX package takes its XLA
                # scan in zeros mode because its Pallas rollout measured slower
                # on a TPU (lns_tpu/models/latent_dynamics.py: _pallas_rollout_ok);
                # on an H100 kernel 1 runs the two-phase rollout (B8 x 78 steps
                # at 7x15) in about 13 ms against 220-280 ms for the plain step
                # loop (chip_smoke.py; PERF.md's kernel table)
                with profiling.span("lns.pack"):
                    packed = pack_simple_cnn(p, self.dtype or torch.float32)
                with profiling.span("lns.rollout", steps=steps, path="kernel"):
                    zs = fused_rollout(z, packed, steps, p.prop_n_block, p.dilation,
                                       p.padding_mode)
                return zs.transpose(0, 1)
            zs = []
            with profiling.span("lns.rollout", steps=steps, path="loop"):
                for _ in range(steps):
                    z = self._step(z, shared)
                    zs.append(z)
                    profiling.count(LOOP_STEPS, z.shape[0])
            return torch.stack(zs, dim=1)

    @torch.no_grad()
    def predict(self, x: torch.Tensor, steps: int, cond: Optional[torch.Tensor] = None,
                to_x: bool = True, decode_chunk: Optional[int] = None) -> torch.Tensor:
        """Encode -> `steps` propagator steps -> decode:
        x [b, H, W, c] -> [b, steps, H, W, c] (latents when not `to_x`);
        cond [b] for a conditional model.

        The b * steps latents are decoded `decode_chunk` frames at a time
        (all at once when None); the last chunk is zero-padded to full size,
        as the JAX package does, so every chunk has one shape."""
        with profiling.span("lns.predict", root=True, batch=x.shape[0], steps=steps,
                            to_x=to_x, decode_chunk=decode_chunk):
            zs = self._latents(x, steps, cond)
            if not to_x:
                return zs
            b, t = zs.shape[:2]
            zflat = zs.reshape((b * t,) + zs.shape[2:])
            if decode_chunk is None:
                y = self.decode(zflat)
            else:
                n = b * t
                pad = (-n) % decode_chunk
                zpad = F.pad(zflat, (0, 0) * (zflat.dim() - 1) + (0, pad))
                y = torch.cat([self.decode(c) for c in zpad.split(decode_chunk)])[:n]
            return y.reshape((b, t) + y.shape[1:])
