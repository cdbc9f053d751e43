"""The plain reference of the conditional two-phase (tank-sloshing) LNS
surrogate's forward pass, in plain PyTorch: the zero-padded, non-square
autoencoder's encoder and decoder and one step of the FiLM-conditioned
propagator, over a flat state dict under the reference trainer's key names
(``ae.*``, ``propagator.*``). It imports nothing of the program under test,
holds no module objects and takes only the state dict, the fields and each
sample's parameter.

It follows BaratiLab/LNS-Latent-Neural-PDE-Solver (arXiv:2402.17853):
``modules/autoencoder2d_nonsquared.py`` (``SimpleAutoencoder``, which the
conditional stage-2 trainer builds: zero padding, a stride-2 downsample after
padding (0, 1), a 61x121 field to a 7x15 latent, an SABlock with a learned
positional embedding at 7x15, nearest 2x upsamples, a nearest resize to the
field, a GN(32) tail), ``modules/basics.py`` (residual and self-attention
blocks) and ``train_stage2_twophase_conditional.py:25-121``
(``CondDilatedResidualBlock``, ``CondSimpleCNN``): the parameter's Fourier
embedding and a GELU MLP; per block GN(1) -> conv3 -> GELU -> dilated conv3
plus the block's projection of the embedding, GN(1) -> GELU -> conv3 gated
residual, then the FFN of the input scaled by ``1 + c`` (FiLM, c from the
embedding through GN(1) -> 1x1 -> GELU -> 1x1), residual; GN(32) -> 1x1 out.
It computes in float32 throughout, where the program promotes the FiLM path
to float32 and runs the rest in bfloat16.

Departures, each noted where it is computed:

* the conditioning embedding is ``latent_dim`` wide, as the port and the
  JAX package build it (``param_shapes``);
* ``conditioning(cond)`` is computed apart from the step: what depends on
  the parameter alone (the embedding, its MLP, each block's projection and
  FiLM scale), which the published block recomputes each step; ``step``
  calls it once per call, so the result is the published one;
* the nearest 2x upsample and the resize run before their convs as
  published (the program folds the 2x into a transposed conv).

It keeps the reference-module contract written in ``portbench/harness.py``'s
docstring (``param_shapes``, ``init_kind``, ``LNS`` with ``encode``,
``conditioning``, ``step(z, cond)`` and ``decode``, ``p`` and ``calls``).
The autoencoder holds no factorized attention, so ``channel_fab`` changes
nothing. ``fp8``: False computes in float32 (the reference); True rounds
every weight once and every layer's output to fp8 e4m3 (saturating), with
float32 accumulation (the control of ``portbench/control.py``). TF32 is off
for the reference's own work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference.lns import FP8, FP8_MAX, _conv_shapes, _norm_shapes, _Norm, _res_shapes, no_tf32

Shapes = Dict[str, Tuple[int, ...]]


# -- the architecture: (kind, arguments) per nn.Sequential index -------------

def _check(cfg) -> None:
    if cfg.get("is_periodic") or cfg.get("periodic_direction") or not cfg.get("resolutions"):
        raise ValueError("reference/twophase_cond.py holds the zero-padded non-square model")
    if cfg.get("fourier_resolutions") or cfg.get("use_attn_enc") or cfg.get("final_smoothing"):
        raise ValueError("the reference holds no Fourier layers and no encoder attention")
    if cfg.get("disable_coarse_attn"):
        raise ValueError("the reference holds the decoder with its coarse SABlock")


def encoder_layers(cfg) -> List[tuple]:
    """The encoder's stack (autoencoder2d_nonsquared.py ``Encoder``), one
    entry per nn.Sequential index."""
    _check(cfg)
    ch = list(cfg["encoder_channels"])
    if len(ch) - 2 != int(math.log2(cfg["resolutions"][0] // cfg["latent_resolution"])):
        raise ValueError("encoder_channels do not match the latent resolution")
    out = [("conv1", ch[0]), ("swish",), ("conv3", ch[0], ch[0])]
    for i in range(len(ch) - 1):
        cin = ch[i]
        for _ in range(cfg["encoder_res_blocks"]):
            out.append(("res", cin, ch[i + 1]))
            cin = ch[i + 1]
        if i != len(ch) - 2:
            out.append(("down", ch[i + 1]))
    out += [("res", ch[-1], ch[-1]), ("gn", 32, 1e-6), ("swish",), ("conv1", cfg["latent_dim"])]
    return out


def _tokens(cfg, r: int) -> int:
    """The SABlock's positional-embedding length at latent height r."""
    ratio = cfg["resolutions"][1] / cfg["resolutions"][0]
    return r * int(r * (ratio + 0.5))


def decoder_layers(cfg) -> List[tuple]:
    """The decoder's stack, one entry per nn.Sequential index: conv3, res,
    an SABlock, res; per level a res block and between levels a nearest 2x
    upsample and conv3; a nearest resize to the field, conv3, conv3, GN(32),
    swish and a 1x1 to the field's channels."""
    _check(cfg)
    ch = list(cfg["decoder_channels"])
    attn = list(cfg.get("attn_resolutions") or [])
    heads, dim_head = cfg["decoder_attn_heads"], cfg["decoder_attn_dim"]
    r = cfg["latent_resolution"]
    cin = ch[0]
    out = [("conv3", cfg["latent_dim"], cin), ("res", cin, cin),
           ("sa", heads, dim_head, _tokens(cfg, r)), ("res", cin, cin)]
    for i, cout in enumerate(ch):
        for _ in range(cfg["decoder_res_blocks"]):
            out.append(("res", cin, cout))
            cin = cout
            if r in attn:
                raise ValueError("the reference holds no factorized attention in the decoder")
        if i != 0 and i != len(ch) - 1:
            out.append(("up", cin))
            r *= 2
    if cfg["Ly"] in attn:
        raise ValueError("the reference holds no factorized attention in the decoder")
    out += [("resize", cfg["Ly"], cfg["Lx"]), ("conv3", cin, cin), ("conv3", cin, cin),
            ("gn", 32, 1e-6), ("swish",), ("conv1", cfg["in_channels"])]
    return out


# -- the state dict's names and shapes ---------------------------------------

def _linear_shapes(name, cout, cin) -> Shapes:
    return {f"{name}.weight": (cout, cin), f"{name}.bias": (cout,)}


def _stack_shapes(prefix, layers, cin) -> Shapes:
    out: Shapes = {}
    for idx, layer in enumerate(layers):
        name, kind = f"{prefix}.{idx}", layer[0]
        if kind == "conv1":
            out.update(_conv_shapes(name, layer[1], cin, 1))
            cin = layer[1]
        elif kind == "conv3":
            out.update(_conv_shapes(name, layer[2], cin, 3))
            cin = layer[2]
        elif kind == "res":
            out.update(_res_shapes(name, layer[1], layer[2], True))  # basics.py's block.* names
            cin = layer[2]
        elif kind in ("down", "up"):
            out.update(_conv_shapes(f"{name}.conv_layer", cin, cin, 3))
        elif kind == "gn":
            out.update(_norm_shapes(f"{name}.gn", cin))
        elif kind == "sa":
            hd = layer[1] * layer[2]
            out.update({f"{name}.pe": (1, layer[3], cin), **_norm_shapes(f"{name}.ln", cin),
                        f"{name}.to_q.weight": (hd, cin), f"{name}.to_k.weight": (hd, cin),
                        **_linear_shapes(f"{name}.to_v", hd, cin),
                        **_linear_shapes(f"{name}.proj_out", cin, hd)})
    return out


def param_shapes(cfg) -> Shapes:
    """Every parameter of the model and its shape, under the reference
    trainer's names: the autoencoder under ``ae``, the propagator under
    ``propagator``. The conditioning embedding is ``latent_dim`` wide (a
    departure: the port and the JAX package build it so)."""
    lat, c, e = cfg["latent_dim"], cfg["prop_n_embd"], cfg["latent_dim"]
    s = _stack_shapes("ae.encoder.model", encoder_layers(cfg), cfg["in_channels"])
    s.update(_conv_shapes("ae.quant_conv", lat, lat, 1))
    s.update(_conv_shapes("ae.post_quant_conv", lat, lat, 1))
    s.update(_stack_shapes("ae.decoder.model", decoder_layers(cfg), lat))
    s.update(_conv_shapes("propagator.in_proj", c, lat, 1))
    s.update(_linear_shapes("propagator.cond_emb_proj.0", e, e))
    s.update(_linear_shapes("propagator.cond_emb_proj.2", e, e))
    for i in range(cfg["prop_n_block"]):
        p = f"propagator.net.{i}"
        s.update(_linear_shapes(f"{p}.cond_emb", c, e))
        s.update(_norm_shapes(f"{p}.conv1.0", c))
        s.update(_conv_shapes(f"{p}.conv1.1", c, c, 3))
        s.update(_conv_shapes(f"{p}.conv1.3", c, c, 3))
        s.update(_norm_shapes(f"{p}.cond_conv1.0", c))
        s.update(_conv_shapes(f"{p}.cond_conv1.2", c, c, 3))
        s.update(_norm_shapes(f"{p}.cond_conv2.0", c))
        s.update(_conv_shapes(f"{p}.cond_conv2.1", c, c, 1))
        s.update(_conv_shapes(f"{p}.cond_conv2.3", c, c, 1))
        s.update(_norm_shapes(f"{p}.ffn.0", c))
        s.update(_conv_shapes(f"{p}.ffn.1", c, c, 1, bias=False))
        s.update(_conv_shapes(f"{p}.ffn.3", c, c, 1, bias=False))
    s.update(_norm_shapes("propagator.out_proj.0.gn", c))
    s.update(_conv_shapes("propagator.out_proj.1", lat, c, 1))
    return s


def init_kind(name: str, shape) -> str:
    """How the benchmark draws a parameter: 'uniform' (a conv or linear
    weight or bias, torch's default), 'normal' (the SABlock's learned
    positional embedding, N(0, 0.02)) or 'norm' (a GroupNorm or LayerNorm
    scale or shift, as ``param_shapes`` marks it)."""
    if name.endswith(".pe"):
        return "normal"
    return "norm" if isinstance(shape, _Norm) else "uniform"


# -- the forward pass ----------------------------------------------------------

def fourier_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """[B] scalars -> [B, dim]: cos(t f) | sin(t f), f = max_period^(-k /
    (dim // 2)) for k < dim // 2, a zero column more when dim is odd
    (modules/cond_utils.py)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, dim % 2))


class LNS:
    """The reference model over a state dict: ``encode`` x [B, H, W, C] ->
    z [B, h, w, latent], ``conditioning`` cond [B] -> each block's
    (projection, FiLM scale), ``step`` (z, cond) -> z, ``decode`` z -> x,
    all NHWC and float32. ``calls`` records every autoencoder GroupNorm
    ('gn', elements, channels) for the benchmark's work counts; ``step``
    records none."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor], fp8: bool = False,
                 channel_fab: bool = False):
        self.cfg = cfg
        self.fp8 = fp8
        self.enc = encoder_layers(cfg)
        self.dec = decoder_layers(cfg)
        self.p = {k: self._q(v.float()) for k, v in params.items()}
        self.calls: List[tuple] = []

    # rounding of the lower-precision form
    def _q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        return t.clamp(-FP8_MAX, FP8_MAX).to(FP8).float()  # saturating, as a kernel's cast

    # elementary layers, NCHW
    def conv(self, x, name, pad=0, stride=1, dil=1):
        return self._q(F.conv2d(x, self.p[f"{name}.weight"], self.p.get(f"{name}.bias"),
                                stride, pad, dil))

    def linear(self, x, name):
        w = self.p[f"{name}.weight"]
        return self._q(F.linear(x, w.reshape(w.shape[0], -1), self.p.get(f"{name}.bias")))

    def norm(self, x, groups, eps, name):
        """A GroupNorm over x [B, C, ...] with its affine."""
        return self._q(F.group_norm(x, groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                                    eps))

    def gn(self, x, name, swish):
        """An autoencoder GroupNorm(32) (+ swish): one call of the program's
        kernel 3, recorded."""
        self.calls.append(("gn", x.numel(), x.shape[1]))
        y = self.norm(x, 32, 1e-6, name)
        return self.swish(y) if swish else y

    def gelu(self, x):
        return self._q(F.gelu(x))

    def swish(self, x):
        return self._q(x * torch.sigmoid(x))

    # blocks
    def res(self, x, name, cin, cout):
        h = self.conv(self.gn(x, f"{name}.block.0.gn", True), f"{name}.block.2", pad=1)
        h = self.conv(self.gn(h, f"{name}.block.3.gn", True), f"{name}.block.5", pad=1)
        if cin != cout:
            x = self.conv(x, f"{name}.channel_up")
        return self._q(x + h)

    def down(self, x, name):
        """Zero padding (0, 1) on each axis, then a stride-2 conv3."""
        return self.conv(F.pad(x, (0, 1, 0, 1)), f"{name}.conv_layer", stride=2)

    def up(self, x, name):
        """Nearest 2x, then conv3 (as published: a departure from the
        program's folded form only in how it is computed)."""
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                         f"{name}.conv_layer", pad=1)

    def sa(self, x, name, heads, dim_head):
        """SABlock: LayerNorm, the learned positional embedding, softmax
        attention over the row-major tokens, proj_out, residual on the
        block's input."""
        b, c, hh, ww = x.shape
        t = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self._q(F.layer_norm(t, (c,), self.p[f"{name}.ln.weight"], self.p[f"{name}.ln.bias"],
                                 1e-5))
        h = self._q(h + self.p[f"{name}.pe"][:, :hh * ww])

        def split(v):
            return v.reshape(b, hh * ww, heads, dim_head).transpose(1, 2)
        q, k, v = (split(self.linear(h, f"{name}.{n}")) for n in ("to_q", "to_k", "to_v"))
        a = self._q((self._q(q @ k.transpose(-1, -2)) * dim_head ** -0.5).softmax(dim=-1))
        o = self._q(a @ v).transpose(1, 2).reshape(b, hh * ww, -1)
        t = self._q(t + self.linear(o, f"{name}.proj_out"))
        return t.reshape(b, hh, ww, c).permute(0, 3, 1, 2)

    def _stack(self, x, prefix, layers):
        for idx, layer in enumerate(layers):
            name, kind = f"{prefix}.{idx}", layer[0]
            if kind == "conv1":
                x = self.conv(x, name)
            elif kind == "conv3":
                x = self.conv(x, name, pad=1)
            elif kind == "swish" and not (idx and layers[idx - 1][0] == "gn"):
                x = self.swish(x)
            elif kind == "res":
                x = self.res(x, name, layer[1], layer[2])
            elif kind == "down":
                x = self.down(x, name)
            elif kind == "up":
                x = self.up(x, name)
            elif kind == "resize":
                x = F.interpolate(x, size=layer[1:], mode="nearest")
            elif kind == "gn":  # the swish after it is applied with it
                x = self.gn(x, f"{name}.gn", idx + 1 < len(layers) and layers[idx + 1][0] == "swish")
            elif kind == "sa":
                x = self.sa(x, name, layer[1], layer[2])
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = self._stack(self._q(x.float()).permute(0, 3, 1, 2), "ae.encoder.model", self.enc)
            return self.conv(h, "ae.quant_conv").permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = self.conv(self._q(z.float()).permute(0, 3, 1, 2), "ae.post_quant_conv")
            return self._stack(h, "ae.decoder.model", self.dec).permute(0, 2, 3, 1)

    # the propagator
    def conditioning(self, cond: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """What the step takes from each sample's parameter alone: the
        Fourier embedding -> Linear -> GELU -> Linear, then per block its
        projection ``cond_emb`` [B, C] and its FiLM scale c [B, C]
        (GN(1) of the projection -> 1x1 -> GELU -> 1x1)."""
        with no_tf32():
            dim = self.p["propagator.cond_emb_proj.0.weight"].shape[1]
            emb = self._q(fourier_embedding(cond, dim))
            emb = self.linear(self.gelu(self.linear(emb, "propagator.cond_emb_proj.0")),
                              "propagator.cond_emb_proj.2")
            out = []
            for i in range(self.cfg["prop_n_block"]):
                p = f"propagator.net.{i}"
                e = self.linear(emb, f"{p}.cond_emb")
                c = self.norm(e[:, :, None, None], 1, 1e-5, f"{p}.cond_conv2.0")[:, :, 0, 0]
                c = self.linear(self.gelu(self.linear(c, f"{p}.cond_conv2.1")), f"{p}.cond_conv2.3")
                out.append((e, c))
            return out

    @staticmethod
    def film(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """FiLM: x [B, C, H, W] scaled by 1 + c [B, C]."""
        return x * (1 + c[:, :, None, None])

    def step(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """One CondSimpleCNN step of z [B, h, w, latent] on each row's
        parameter cond [B]: in_proj; per block GN(1) -> conv3 -> GELU ->
        dilated conv3 + the projection, GN(1) -> GELU -> conv3, residual;
        GN(1) of FiLM(x, c) -> 1x1 -> GELU -> 1x1, residual; GN(32) -> out
        1x1."""
        dil = self.cfg["dilation"]
        shared = self.conditioning(cond)
        with no_tf32():
            h = self.conv(self._q(z.float()).permute(0, 3, 1, 2), "propagator.in_proj")
            for i, (e, c) in enumerate(shared):
                p = f"propagator.net.{i}"
                t = self.gelu(self.conv(self.norm(h, 1, 1e-5, f"{p}.conv1.0"), f"{p}.conv1.1",
                                        pad=1))
                t = self._q(self.conv(t, f"{p}.conv1.3", pad=dil, dil=dil) + e[:, :, None, None])
                g = self.conv(self.gelu(self.norm(t, 1, 1e-5, f"{p}.cond_conv1.0")),
                              f"{p}.cond_conv1.2", pad=1)
                h = self._q(h + g)
                f = self.norm(self._q(self.film(h, c)), 1, 1e-5, f"{p}.ffn.0")
                f = self.conv(self.gelu(self.conv(f, f"{p}.ffn.1")), f"{p}.ffn.3")
                h = self._q(h + f)
            h = self.norm(h, 32, 1e-6, "propagator.out_proj.0.gn")
            return self.conv(h, "propagator.out_proj.1").permute(0, 2, 3, 1)
