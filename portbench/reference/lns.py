"""The plain reference of the LNS latent surrogate's forward pass, in plain
PyTorch: the autoencoder's encoder and decoder and one step of the SimpleCNN
propagator, over a flat state dict under the reference trainer's key names
(``vq_ae.*``, ``propagator.*``). It imports nothing of the program under
test, holds no module objects and takes only the state dict and the fields.

It follows BaratiLab/LNS-Latent-Neural-PDE-Solver (arXiv:2402.17853):
``modules/autoencoder2d.py`` (the periodic square variant, NS2d),
``modules/autoencoder2d_half_periodic.py`` (SW: the width wraps, the height
is zero-padded), ``modules/factorized_attention.py`` (FABlock2D),
``modules/basics.py`` (residual, resampling and self-attention blocks) and
the stage-2 trainers' ``SimpleCNN``. Two departures, each an exact
rewriting of the published arithmetic, and each held to the published form
in float64 by ``portbench/tests/test_portbench_reference.py``:

* a nearest-2x upsample followed by a 3x3 conv is one stride-2 transposed
  conv over the small grid with the box-summed 4x4 kernel (``up2x_conv``);
* a half-periodic 3x3, stride-1, pad-1 conv is a zero-padded conv plus the
  two wrapped boundary strips (``strip_conv``).

It keeps the reference-module contract written in ``portbench/harness.py``'s
docstring (``param_shapes``, ``init_kind``, ``LNS`` with ``encode``, ``step``
and ``decode``, ``p`` and ``calls``); its step takes no parameter.

The factorized attention's core is computed as published (in_proj, both
axial kernels on the value, InstanceNorm2d, out_fc1: ``fab_core``). With
``channel_fab`` it runs in channel space instead (``fab_core_channel``:
both axial kernels applied to the normalised field, the InstanceNorm's
moments taken from the channel Gram, in_proj, the InstanceNorm and out_fc1
folded into one matrix per (sample, head)), the form of the port's plain
path; ``work.py`` counts that form's operations (``FlopCounterMode``) as the
model's FLOPs, so the counts do not depend on which form the program
computes. Every product is a two-operand one, so the count does not depend
on an einsum path either.

``fp8``: False computes in float32 throughout (the reference); True rounds
every weight once and every layer's output to fp8 e4m3 (saturating), with
float32 accumulation: the same model in a lower precision (the control of
``portbench/control.py``). The reference turns TF32 off for its own work
and restores the global flags after.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Shapes = Dict[str, Tuple[int, ...]]


# -- the architecture: (kind, arguments) per nn.Sequential index -------------

def _variant(cfg) -> str:
    if cfg.get("periodic_direction"):
        return "half_periodic"
    if cfg.get("resolutions") is not None or not cfg.get("is_periodic"):
        raise ValueError("reference/lns.py holds the periodic square (NS2d) and the "
                         "half-periodic (SW) models only; another configuration brings its "
                         "own reference module, reference/<name>.py named by its 'reference' "
                         "key, keeping the contract in harness.py's docstring")
    return "periodic"


def _heads(cfg) -> Tuple[int, int]:
    if _variant(cfg) == "periodic":
        return cfg["attn_heads"], cfg["attn_dim"]
    return cfg["decoder_attn_heads"], cfg["decoder_attn_dim"]


def padding_mode(cfg) -> str:
    return "hpx" if _variant(cfg) == "half_periodic" else "circular"


def encoder_layers(cfg) -> List[tuple]:
    """The encoder's stack (autoencoder2d.py / autoencoder2d_half_periodic.py
    ``Encoder``), one entry per nn.Sequential index."""
    ch = list(cfg["encoder_channels"])
    if cfg.get("use_attn_enc") or cfg.get("fourier_resolutions"):
        raise ValueError("the reference holds no encoder attention or Fourier layers")
    res_h = cfg["resolution"] if _variant(cfg) == "periodic" else cfg["resolutions"][0]
    if len(ch) - 2 != int(math.log2(res_h // cfg["latent_resolution"])):
        raise ValueError("encoder_channels do not match the latent resolution")
    n_res = cfg["encoder_res_blocks"]
    if _variant(cfg) == "periodic":
        out = [("conv1", ch[0]), ("swish",), ("conv3", ch[0], ch[0])]
        for i in range(len(ch) - 1):
            cin = ch[i]
            for _ in range(n_res):
                out.append(("res", cin, ch[i + 1]))
                cin = ch[i + 1]
            if i != len(ch) - 2:
                out.append(("down", ch[i + 1]))
        out.append(("conv3", ch[-1], ch[-1]))
    else:
        out = [("conv1", ch[0]), ("swish",), ("res", ch[0], ch[0])]
        for i in range(len(ch) - 1):
            cin = ch[i]
            for _ in range(n_res):
                out.append(("res", cin, ch[i + 1]))
                cin = ch[i + 1]
            if i != len(ch) - 2:
                out.append(("down", ch[i + 1]))
        out.append(("res", ch[-1], ch[-1]))
    out += [("gn", 32, 1e-6, "gn"), ("swish",), ("conv1", cfg["latent_dim"])]
    return out


def decoder_layers(cfg) -> List[tuple]:
    """The decoder's stack, one entry per nn.Sequential index: a coarse
    self-attention block, res blocks and FABlock2Ds at ``attn_resolutions``,
    2x upsamples, the last 2x folded into the following conv (its resize
    keeps an index), then a GroupNorm, swish and the 1x1 to the field."""
    ch = list(cfg["decoder_channels"])
    attn = list(cfg.get("attn_resolutions") or [])
    heads, dim_head = _heads(cfg)
    res_h = cfg["latent_resolution"]
    n_res = cfg["decoder_res_blocks"]
    if cfg.get("disable_coarse_attn") or cfg.get("final_smoothing") or not cfg.get("use_fa"):
        raise ValueError("the reference holds the decoder with coarse attention and FAB blocks")
    periodic = _variant(cfg) == "periodic"
    cin = ch[0]
    if periodic:
        out = [("conv1", cin), ("res", cin, cin), ("sa", heads, dim_head, True), ("res", cin, cin)]
    else:
        out = [("conv3", cin, cin), ("sa", heads, dim_head, False), ("res", cin, cin)]
    for i, cout in enumerate(ch):
        for _ in range(n_res):
            out.append(("res", cin, cout))
            cin = cout
            if not periodic and res_h in attn:  # inside the loop in this variant
                out.append(("fab", cin, heads, dim_head))
        if periodic and res_h in attn:
            out.append(("fab", cin, heads, dim_head))
        if i != 0 and i != len(ch) - 1:
            out.append(("up", cin))
            res_h *= 2
    if cfg["Ly"] != 2 * res_h:
        raise ValueError("the reference holds a decoder whose last resize is an exact 2x")
    out += [("resize",), ("tailup", cin)]  # the resize's 2x is the next conv's
    if cfg["Ly"] in attn:
        out.append(("fab", cin, heads, dim_head))
    if periodic:
        out += [("conv1", cin), ("gn", 8, 1e-5, "raw")]
    else:
        out += [("conv3", cin, cin), ("gn", 32, 1e-6, "gn")]
    out += [("swish",), ("conv1", cfg["in_channels"])]
    return out


# -- the state dict's names and shapes ---------------------------------------

def _conv_shapes(name, cout, cin, k, bias=True) -> Shapes:
    s = {f"{name}.weight": (cout, cin, k, k)}
    if bias:
        s[f"{name}.bias"] = (cout,)
    return s


class _Norm(tuple):
    """The shape of a norm layer's scale or shift."""


def _norm_shapes(name, c) -> Shapes:
    return {f"{name}.weight": _Norm((c,)), f"{name}.bias": _Norm((c,))}


def _res_shapes(name, cin, cout, periodic) -> Shapes:
    if periodic:
        s = {**_norm_shapes(f"{name}.block.0.gn", cin), **_conv_shapes(f"{name}.block.2", cout, cin, 3),
             **_norm_shapes(f"{name}.block.3.gn", cout),
             **_conv_shapes(f"{name}.block.5", cout, cout, 3)}
    else:
        s = {**_norm_shapes(f"{name}.norm_act1.norm_act.0.gn", cin),
             **_conv_shapes(f"{name}.conv1", cout, cin, 3),
             **_norm_shapes(f"{name}.norm_act2.norm_act.0.gn", cout),
             **_conv_shapes(f"{name}.conv2", cout, cout, 3)}
    if cin != cout:
        s.update(_conv_shapes(f"{name}.channel_up", cout, cin, 1))
    return s


def _reducer_shapes(name, dim, out_dim) -> Shapes:
    return {f"{name}.to_in.weight": (dim, dim), **_norm_shapes(f"{name}.out_ffn.0", dim),
            f"{name}.out_ffn.1.weight": (2 * dim, dim),
            f"{name}.out_ffn.3.weight": (out_dim, 2 * dim), f"{name}.out_ffn.3.bias": (out_dim,)}


def _fab_shapes(name, dim, heads, dim_head) -> Shapes:
    hd, kd = heads * dim_head, 2 * dim_head
    return {**_norm_shapes(f"{name}.in_norm", dim),
            f"{name}.in_proj.weight": (hd, dim, 1, 1), f"{name}.to_in.0.weight": (dim, dim, 1, 1),
            **_reducer_shapes(f"{name}.to_x.0", dim, dim_head),
            **_reducer_shapes(f"{name}.to_y.1", dim, dim_head),
            f"{name}.low_rank_kernel_x.to_qk.weight": (2 * kd * heads, dim_head),
            f"{name}.low_rank_kernel_y.to_qk.weight": (2 * kd * heads, dim_head),
            f"{name}.to_out.1.weight": (dim, hd, 1, 1), f"{name}.to_out.3.weight": (dim, dim, 1, 1)}


def _sa_shapes(name, dim, heads, dim_head, tokens, use_pe) -> Shapes:
    hd = heads * dim_head
    s = {**_norm_shapes(f"{name}.ln", dim), f"{name}.to_q.weight": (hd, dim),
         f"{name}.to_k.weight": (hd, dim), f"{name}.to_v.weight": (hd, dim),
         f"{name}.to_v.bias": (hd,), f"{name}.proj_out.weight": (dim, hd),
         f"{name}.proj_out.bias": (dim,)}
    if use_pe:
        s[f"{name}.pe"] = (1, tokens, dim)
    return s


def _stack_shapes(prefix, layers, cin, cfg) -> Shapes:
    periodic = _variant(cfg) == "periodic"
    lat = cfg["latent_resolution"]
    ratio = 1 if periodic else cfg["resolutions"][1] / cfg["resolutions"][0]
    tokens = lat * int(lat * (ratio + 0.5)) if not periodic else lat * lat
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
            out.update(_res_shapes(name, layer[1], layer[2], periodic))
            cin = layer[2]
        elif kind in ("down", "up"):
            out.update(_conv_shapes(f"{name}.conv_layer", cin, cin, 3))
        elif kind == "tailup":
            out.update(_conv_shapes(name, cin, cin, 3))
        elif kind == "gn":
            out.update(_norm_shapes(f"{name}.gn" if layer[3] == "gn" else name, cin))
        elif kind == "sa":
            out.update(_sa_shapes(name, cin, layer[1], layer[2], tokens, layer[3]))
        elif kind == "fab":
            out.update(_fab_shapes(name, cin, layer[2], layer[3]))
    return out


def param_shapes(cfg) -> Shapes:
    """Every parameter of the model and its shape, under the reference
    trainer's names: the autoencoder under ``vq_ae``, the propagator under
    ``propagator``."""
    lat, c = cfg["latent_dim"], cfg["prop_n_embd"]
    s = _stack_shapes("vq_ae.encoder.model", encoder_layers(cfg), cfg["in_channels"], cfg)
    s.update(_conv_shapes("vq_ae.quant_conv", lat, lat, 1))
    s.update(_conv_shapes("vq_ae.post_quant_conv", lat, lat, 1))
    s.update(_stack_shapes("vq_ae.decoder.model", decoder_layers(cfg), lat, cfg))
    s.update(_conv_shapes("propagator.in_proj", c, lat, 1))
    for i in range(cfg["prop_n_block"]):
        p = f"propagator.net.{i}"
        s.update(_norm_shapes(f"{p}.conv.0", c))
        for j in (1, 3, 5):
            s.update(_conv_shapes(f"{p}.conv.{j}", c, c, 3))
        s.update(_norm_shapes(f"{p}.ffn.0", c))
        s[f"{p}.ffn.1.weight"] = (c, c, 1, 1)
        s[f"{p}.ffn.3.weight"] = (c, c, 1, 1)
    s.update(_norm_shapes("propagator.out_proj.0.gn", c))
    s.update(_conv_shapes("propagator.out_proj.1", lat, c, 1))
    return s


def init_kind(name: str, shape) -> str:
    """How the benchmark draws a parameter: 'uniform' (a conv or linear
    weight or bias, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default),
    'normal' (the learnable positional embedding, N(0, 0.02)) or 'norm' (a
    GroupNorm or LayerNorm scale or shift, as ``param_shapes`` marks it)."""
    if name.endswith(".pe"):
        return "normal"
    return "norm" if isinstance(shape, _Norm) else "uniform"


# -- the forward pass ----------------------------------------------------------

@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block; the global flags restored after, so the
    program's float32 products in the same process keep theirs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


FP8 = torch.float8_e4m3fn
FP8_MAX = float(torch.finfo(FP8).max)


class LNS:
    """The reference model over a state dict: ``encode`` x [B, H, W, C] ->
    z [B, h, w, latent], ``step`` z -> z, ``decode`` z -> x, all NHWC and
    float32. ``calls`` records every GroupNorm ('gn', elements, channels)
    and factorized-attention core ('fab', b, h, w, c, heads, dim_head,
    dim_out) it runs, for the benchmark's work counts."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor], fp8: bool = False,
                 channel_fab: bool = False):
        self.cfg = cfg
        self.fp8, self.channel_fab = fp8, channel_fab
        self.mode = padding_mode(cfg)
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
    def _pad(self, x, p, mode):
        if mode == "circular":
            return F.pad(x, (p, p, p, p), mode="circular")
        if mode == "hpx":  # the width wraps, the height is zero-padded
            return F.pad(F.pad(x, (p, p, 0, 0), mode="circular"), (0, 0, p, p))
        return F.pad(x, (p, p, p, p))

    def conv(self, x, name, pad=0, stride=1, dil=1, bias=True):
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias") if bias else None
        if self.mode == "hpx" and w.shape[2] == 3 and (pad, stride, dil) == (1, 1, 1):
            out = strip_conv(x, w)
        else:
            out = F.conv2d(self._pad(x, pad, self.mode) if pad else x, w, None, stride, 0, dil)
        if b is not None:
            out = out + b[:, None, None]
        return self._q(out)

    def up(self, x, name):
        out = up2x_conv(x, self.p[f"{name}.weight"], self.mode) + self.p[f"{name}.bias"][:, None, None]
        return self._q(out)

    def linear(self, x, name, bias=True):
        w = self.p[f"{name}.weight"]
        return self._q(F.linear(x, w.reshape(w.shape[0], -1),
                                self.p.get(f"{name}.bias") if bias else None))

    def _norm(self, x, groups, eps, name):
        return F.group_norm(x, groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"], eps)

    def gn(self, x, groups, eps, name, swish=False):
        """An autoencoder GroupNorm (+ swish): one call of the program's
        kernel 3, recorded."""
        self.calls.append(("gn", x.numel(), x.shape[1]))
        y = self._norm(x, groups, eps, name)
        return self._q(y * torch.sigmoid(y) if swish else y)

    def ln(self, x, name):
        return self._q(F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                                    self.p[f"{name}.bias"], 1e-5))

    def gelu(self, x):
        return self._q(F.gelu(x))

    def swish(self, x):
        return self._q(x * torch.sigmoid(x))

    def mm(self, eq, a, b):
        return self._q(torch.einsum(eq, a, b))

    # blocks
    def res(self, x, name, cin, cout):
        if self.mode == "circular":
            h = self.gn(x, 32, 1e-6, f"{name}.block.0.gn", swish=True)
            h = self.conv(h, f"{name}.block.2", pad=1)
            h = self.gn(h, 32, 1e-6, f"{name}.block.3.gn", swish=True)
            h = self.conv(h, f"{name}.block.5", pad=1)
        else:
            h = self.gn(x, 32, 1e-6, f"{name}.norm_act1.norm_act.0.gn", swish=True)
            h = self.conv(h, f"{name}.conv1", pad=1)
            h = self.gn(h, 32, 1e-6, f"{name}.norm_act2.norm_act.0.gn", swish=True)
            h = self.conv(h, f"{name}.conv2", pad=1)
        if cin != cout:
            x = self.conv(x, f"{name}.channel_up")
        return self._q(x + h)

    def down(self, x, name):
        if self.mode == "circular":  # circular pad (1, 1), then a stride-2 conv
            return self.conv(F.pad(x, (1, 1, 1, 1), mode="circular"), f"{name}.conv_layer",
                             stride=2)
        return self.conv(x, f"{name}.conv_layer", pad=1, stride=2)

    def sa(self, x, name, heads, dim_head, use_pe):
        b, c, hh, ww = x.shape
        t = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.ln(t, f"{name}.ln")
        if use_pe:
            h = self._q(h + self.p[f"{name}.pe"][:, :hh * ww])

        def split(v):
            return v.reshape(b, hh * ww, heads, dim_head).transpose(1, 2)
        q = split(self.linear(h, f"{name}.to_q", bias=False))
        k = split(self.linear(h, f"{name}.to_k", bias=False))
        v = split(self.linear(h, f"{name}.to_v"))
        a = self._q((self.mm("bhid,bhjd->bhij", q, k) * dim_head ** -0.5).softmax(dim=-1))
        o = self.mm("bhij,bhjd->bhid", a, v).transpose(1, 2).reshape(b, hh * ww, -1)
        t = self._q(t + self.linear(o, f"{name}.proj_out"))
        return t.reshape(b, hh, ww, c).permute(0, 3, 1, 2)

    def reducer(self, x, name):
        """PoolingReducer: [b, n1, n2, c] -> [b, n1, out]."""
        x = self.linear(x, f"{name}.to_in", bias=False)
        x = self._q(x.mean(dim=2))
        x = self.ln(x, f"{name}.out_ffn.0")
        x = self.gelu(self.linear(x, f"{name}.out_ffn.1", bias=False))
        return self.linear(x, f"{name}.out_ffn.3")

    def low_rank(self, x, name, heads, dim_head):
        """LowRankKernel: descriptors [b, n, latent] -> K [b, heads, n, n],
        q k^T with rotary embeddings of positions linspace(0, 1, n)."""
        b, n, _ = x.shape
        kd = 2 * dim_head
        qk = self.linear(x, f"{name}.to_qk", bias=False)
        q, k = (t.reshape(b, n, heads, kd).transpose(1, 2) for t in qk.chunk(2, dim=-1))
        inv_freq = (1.0 / 10000.0 ** (torch.arange(0, kd, 2, dtype=torch.float64,
                                                   device=x.device) / kd)).float()
        pos = torch.linspace(0, 1, n, device=x.device)[None] * 64.0  # min_freq 1/64
        f = torch.einsum("...i,j->...ij", pos, inv_freq)
        f = torch.cat((f, f), dim=-1)[:, None]

        def rot(t):
            r = torch.cat((-t[..., kd // 2:], t[..., :kd // 2]), dim=-1)
            return self._q(t * f.cos() + r * f.sin())
        return self.mm("bhid,bhjd->bhij", rot(q), rot(k))

    def fab(self, x, name, dim, heads, dim_head):
        skip = x
        u = self.gn(x, 1, 1e-5, f"{name}.in_norm").permute(0, 2, 3, 1)  # [b, h, w, c]
        b, h, w, c = u.shape
        u_in = self.linear(u, f"{name}.to_in.0", bias=False)
        kx = self.low_rank(self.reducer(u_in, f"{name}.to_x.0"), f"{name}.low_rank_kernel_x",
                           heads, dim_head)
        ky = self.low_rank(self.reducer(u_in.transpose(1, 2), f"{name}.to_y.1"),
                           f"{name}.low_rank_kernel_y", heads, dim_head)
        w_in = self.p[f"{name}.in_proj.weight"][:, :, 0, 0].t().reshape(c, heads, dim_head)
        w_o1 = self.p[f"{name}.to_out.1.weight"][:, :, 0, 0].t().reshape(heads, dim_head, -1)
        self.calls.append(("fab", b, h, w, c, heads, dim_head, w_o1.shape[-1]))
        core = self.fab_core_channel if self.channel_fab else self.fab_core
        out = core(u, kx, ky, w_in, w_o1)
        out = self.linear(self.gelu(out), f"{name}.to_out.3", bias=False)
        return self._q(out.permute(0, 3, 1, 2) + skip)

    def fab_core(self, u, kx, ky, w_in, w_o1, eps=1e-5):
        """FABlock2D's core as published: the value x = u W_in per head n,
        k_x[n] along the height and k_y[n] along the width of it, InstanceNorm2d
        over the pixels of each (sample, channel), out_fc1 summed over heads.
        u [b, h, w, c], kx [b, n, h, h], ky [b, n, w, w], w_in [c, n, d],
        w_o1 [n, d, o] -> [b, h, w, o]."""
        b, h, w, _ = u.shape
        n, d = w_in.shape[1:]
        x = self.mm("bhwc,cnd->bndhw", u, w_in)
        x = self.mm("bnih,bndhw->bndiw", kx, x)
        x = self.mm("bnlw,bndiw->bndil", ky, x)
        x = self._q(F.instance_norm(x.reshape(b, n * d, h, w), eps=eps))
        return self.mm("bndhw,ndo->bhwo", x.view(b, n, d, h, w), w_o1)

    def fab_core_channel(self, u, kx, ky, w_in, w_o1, eps=1e-5):
        """``fab_core`` rewritten in channel space: bb_n = k_x[n] . u .
        k_y[n]^T; the mean and E[x^2] of x_n = bb_n W_in[:, n] from the mean
        of bb_n and its c x c Gram; out = sum_n bb_n (W_in[:, n] diag(inv_n)
        W_o1[n]) - (mean_n inv_n) W_o1[n]. Same arguments and result."""
        b, h, w, c = u.shape
        if w > h:  # k_x first: bb indexed (w, h)
            bb = self.mm("bnlw,bnwic->bnlic", ky, self.mm("bnih,bhwc->bnwic", kx, u))
        else:  # k_y first: bb indexed (h, w)
            bb = self.mm("bnih,bnhlc->bnilc", kx, self.mm("bnlw,bhwc->bnhlc", ky, u))
        gram = self.mm("bnilc,bnile->bnce", bb, bb) / (h * w)
        # the pixel mean of bb: the kernels' column sums, their outer product, times u
        kx_s, ky_s = kx.sum(dim=2), ky.sum(dim=2)
        mean_c = self.mm("bnhw,bhwc->bnc", self.mm("bnh,bnw->bnhw", kx_s, ky_s), u) / (h * w)
        mean = self.mm("bnc,cnd->bnd", mean_c, w_in)
        ex2 = self.mm("bncd,cnd->bnd", self.mm("bnce,end->bncd", gram, w_in), w_in)
        inv = torch.rsqrt((ex2 - mean.square()).clamp_min(0.0) + eps)
        m = self.mm("bncd,ndo->bnco", self.mm("cnd,bnd->bncd", w_in, inv), w_o1)
        bias = self.mm("bnd,ndo->bo", mean * inv, w_o1)
        if w > h:
            out = self.mm("bnlic,bnco->blio", bb, m).transpose(1, 2)
        else:
            out = self.mm("bnilc,bnco->bilo", bb, m)
        return self._q(out - bias[:, None, None, :])

    def _stack(self, x, prefix, layers, cin):
        for idx, layer in enumerate(layers):
            name, kind = f"{prefix}.{idx}", layer[0]
            if kind == "conv1":
                x = self.conv(x, name)
                cin = layer[1]
            elif kind == "conv3":
                x = self.conv(x, name, pad=1)
                cin = layer[2]
            elif kind == "swish" and not (idx and layers[idx - 1][0] == "gn"):
                x = self.swish(x)
            elif kind == "res":
                x = self.res(x, name, layer[1], layer[2])
                cin = layer[2]
            elif kind == "down":
                x = self.down(x, name)
            elif kind in ("up", "tailup"):
                x = self.up(x, f"{name}.conv_layer" if kind == "up" else name)
            elif kind == "gn":  # a swish after it is applied with it
                x = self.gn(x, layer[1], layer[2], f"{name}.gn" if layer[3] == "gn" else name,
                            swish=idx + 1 < len(layers) and layers[idx + 1][0] == "swish")
            elif kind == "sa":
                x = self.sa(x, name, layer[1], layer[2], layer[3])
            elif kind == "fab":
                x = self.fab(x, name, layer[1], layer[2], layer[3])
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = self._stack(self._q(x.float()).permute(0, 3, 1, 2), "vq_ae.encoder.model",
                            self.enc, self.cfg["in_channels"])
            return self.conv(h, "vq_ae.quant_conv").permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = self.conv(self._q(z.float()).permute(0, 3, 1, 2), "vq_ae.post_quant_conv")
            return self._stack(h, "vq_ae.decoder.model", self.dec,
                               self.cfg["latent_dim"]).permute(0, 2, 3, 1)

    def step(self, z: torch.Tensor) -> torch.Tensor:
        """One SimpleCNN step: in_proj; per block GN(1) -> conv3 -> GELU ->
        dilated conv3 -> GELU -> conv3, residual, GN(1) -> 1x1 -> GELU ->
        1x1, residual; GN(32) -> out 1x1."""
        dil = self.cfg["dilation"]
        with no_tf32():
            h = self.conv(self._q(z.float()).permute(0, 3, 1, 2), "propagator.in_proj")
            for i in range(self.cfg["prop_n_block"]):
                p = f"propagator.net.{i}"
                t = self.gelu(self.conv(self._q(self._norm(h, 1, 1e-5, f"{p}.conv.0")),
                                        f"{p}.conv.1", pad=1))
                t = self.gelu(self.conv(t, f"{p}.conv.3", pad=dil, dil=dil))
                h = self._q(h + self.conv(t, f"{p}.conv.5", pad=1))
                f = self.gelu(self.conv(self._q(self._norm(h, 1, 1e-5, f"{p}.ffn.0")),
                                        f"{p}.ffn.1", bias=False))
                h = self._q(h + self.conv(f, f"{p}.ffn.3", bias=False))
            h = self._q(self._norm(h, 32, 1e-6, "propagator.out_proj.0.gn"))
            return self.conv(h, "propagator.out_proj.1").permute(0, 2, 3, 1)


# -- the exact rewritings ---------------------------------------------------

def up2x_conv(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Nearest-2x upsample, then a 3x3 stride-1 pad-1 conv (no bias) with
    `mode`'s padding, as one transposed conv over the small grid: per axis
    the upsample repeats each pixel twice, so output pixel 2i + r sees
    input pixels through the 4-tap kernel K4 = [K0, K0 + K1, K1 + K2, K2];
    a wrapping axis wraps x by one pixel first."""
    k4 = torch.zeros(w.shape[:2] + (4, 4), dtype=w.dtype, device=w.device)
    for dp in range(2):
        for dq in range(2):
            k4[:, :, dp:dp + 3, dq:dq + 3] += w
    wrap_h, wrap_w = mode == "circular", mode in ("circular", "hpx")
    x = F.pad(x, (1, 1) * wrap_w + (0, 0) * (not wrap_w) + (1, 1) * wrap_h
              + (0, 0) * (not wrap_h), mode="circular") if wrap_h or wrap_w else x
    return F.conv_transpose2d(x, k4.flip(2, 3).transpose(0, 1), None, 2,
                              (3 if wrap_h else 1, 3 if wrap_w else 1))


def strip_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3, stride-1, pad-1 conv (no bias) whose width wraps and height is
    zero-padded, as a zero-padded conv plus what the zero padding left out
    at the first and last column: the wrapped neighbour column through the
    kernel's first (last) column."""
    out = F.conv2d(x, w, None, 1, 1)
    n = x.shape[3]
    lo = F.conv2d(x[..., n - 1:], w[..., :1], None, 1, (1, 0))
    hi = F.conv2d(x[..., :1], w[..., 2:], None, 1, (1, 0))
    return torch.cat([out[..., :1] + lo, out[..., 1:n - 1], out[..., n - 1:] + hi], dim=3)
