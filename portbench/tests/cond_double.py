"""A test double of a reference module (the contract in ``harness.py``'s
docstring) for a tiny conditional two-phase configuration: zero padding, a
61x121x4 field that the encoder takes to a 7x15 latent (not the 7x14 that
``round(7 * 121 / 61)`` would give), and a ``CondSimpleCNN`` step that
FiLM-conditions each sample on its own parameter.

It computes with the port's own modules on their plain path
(``use_kernels(False)``) in float32, so it stands in for the contract, not
for a plain reference: a configuration's own reference is written without
the program. ``fp8`` rounds the weights to e4m3 (saturating) and computes
in float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from lns_tpu_torch.config import Config
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.ops.norms import GroupNorm

WIDTHS = {
    "latent_dim": 16, "Ly": 61, "Lx": 121, "resolutions": [61, 121], "in_channels": 4,
    "latent_resolution": 7, "is_periodic": False, "hw_ratio": 2,
    "encoder_channels": [32, 32, 32, 32, 32], "fourier_resolutions": [],
    "encoder_res_blocks": 1, "use_fa": True, "decoder_channels": [32, 32, 32, 32],
    "attn_resolutions": [15, 30], "decoder_res_blocks": 1, "final_smoothing": False,
    "decoder_attn_heads": 2, "decoder_attn_dim": 16, "disable_coarse_attn": False,
    "prop_n_block": 2, "prop_n_embd": 32, "dilation": 2, "in_tw": 1, "out_tw": 5,
    "noise_level": 0.0, "cond_channels": 1, "cond_emb_channels": 16,
}


class _Norm(tuple):
    """The shape of a norm layer's scale or shift."""


def _model(cfg, device) -> LatentDynamics:
    return LatentDynamics(Config(**cfg), device=device).use_kernels(False)


def param_shapes(cfg) -> Dict[str, tuple]:
    model = _model(cfg, "meta")
    norms = {f"{name}.{k}" for name, mod in model.named_modules() if "Norm" in type(mod).__name__
             for k, _ in mod.named_parameters(recurse=False)}
    return {k: _Norm(v.shape) if k in norms else tuple(v.shape)
            for k, v in model.state_dict().items()}


def init_kind(name: str, shape) -> str:
    if name.endswith(".pe"):
        return "normal"
    return "norm" if isinstance(shape, _Norm) else "uniform"


class LNS:
    def __init__(self, cfg, params: Dict[str, torch.Tensor], fp8: bool = False,
                 channel_fab: bool = False):
        if fp8:
            params = {k: v.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()
                      for k, v in params.items()}
        self.model = _model(cfg, next(iter(params.values())).device)
        self.model.load_state_dict(params, strict=True)
        self.p = self.model.state_dict(keep_vars=True)
        self.calls = []
        for mod in self.model.autoencoder.modules():
            if isinstance(mod, GroupNorm):
                mod.register_forward_hook(
                    lambda m, args, out: self.calls.append(("gn", out.numel(), m.weight.numel())))

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.encode(x.float())

    @torch.no_grad()
    def conditioning(self, cond: torch.Tensor):
        return self.model.propagator.conditioning(cond.float())

    @torch.no_grad()
    def step(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return self.model.propagator.step(z.float(), self.conditioning(cond))

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.decode(z.float())
