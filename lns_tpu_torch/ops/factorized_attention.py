"""Factorized (axial low-rank) attention (reference:
modules/factorized_attention.py), on NCHW tensors.

FABlock2D builds one n x n integral kernel per spatial axis from pooled axis
descriptors (no softmax) and applies both to the value. Its core takes one
of the JAX package's two formulations, by the same rule
(``_fab_impl_for``):

  * c-space (``"batchedgram"``, ``_batched_gram_core``): the kernels apply in
    channel space, and in_proj, the InstanceNorm and out_fc1 fold into one
    per-(sample, head) matrix; the FAB-core kernel (``kernels.fab_core``).
  * d-space (``"batched"``, ``_batched_core``): in_proj first, the axial
    applies and the InstanceNorm on the head-major value
    (``kernels.axial.fab_axial_in_fused``), then out_fc1 summed over heads.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lns_tpu_torch.kernels.axial import axial_stats_plain, fab_axial_in_fused
from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core
from lns_tpu_torch.ops.activations import GELU, gelu
from lns_tpu_torch.ops.conv import Conv1x1, Dense
from lns_tpu_torch.ops.embedding import RotaryEmbedding, apply_rotary_pos_emb
from lns_tpu_torch.ops.norms import GroupNorm, LayerNorm


class LowRankKernel(nn.Module):
    """Per-head n x n kernel on ONE axis (reference:
    factorized_attention.py:11-69): axis descriptors [b, n, dim] ->
    K [b, heads, n, n]. Positions linspace(0, 1, n) go through rotary
    embeddings when ``use_rotary_emb``."""

    def __init__(self, dim: int, dim_head: int, heads: int, use_rotary_emb: bool = False):
        super().__init__()
        self.dim_head = dim_head
        self.heads = heads
        self.to_qk = Dense(dim, dim_head * heads * 2, use_bias=False)
        self.pos_emb = RotaryEmbedding(dim_head) if use_rotary_emb else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.kernel_and_sums(x)[0]

    def kernel_and_sums(self, x: torch.Tensor):
        """(K in x's dtype, the f32 sums of K over its rows [b, heads, n]).

        q k^T is one f32 product rounded once to K's dtype; the sums are
        taken from the f32 product before that rounding, as the jitted JAX
        block's column sums of ``_batched_gram_core`` read it (its
        ``wrapped_reduce`` fusions consume the dot's f32 output, the axial
        applies its bf16 round trip)."""
        b, n, _ = x.shape
        q, k = self.to_qk(x).chunk(2, dim=-1)
        q = q.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k = k.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        if self.pos_emb is not None:
            freqs = self.pos_emb(_linspace01(n, x.device))[:, None].to(q.dtype)  # [1, 1, n, d]
            q = apply_rotary_pos_emb(q, freqs)
            k = apply_rotary_pos_emb(k, freqs)
        kf = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
        return kf.to(x.dtype), kf.sum(dim=2)


def _linspace01(n: int, device) -> torch.Tensor:
    """linspace(0, 1, n) [1, n] as ``jnp.linspace`` computes it in f32: i
    times f32(1 / (n - 1)), the last point 1 (``torch.linspace`` takes the
    upper half from the end, which differs in the last bit). Built on the
    device without a host copy (``pos[-1] = 1.0`` on a CUDA tensor waits for
    the device)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    pos = torch.where(i == n - 1, 1.0, i * (1.0 / max(n - 1, 1))) if n > 1 else i
    return pos.reshape(1, n)


class PoolingReducer(nn.Module):
    """Project, mean-pool all spatial dims but the first, then LN-MLP
    (reference: factorized_attention.py:72-94): [b, n1, n2, c] ->
    [b, n1, out_dim]."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.to_in = Dense(in_dim, hidden_dim, use_bias=False)
        self.out_ffn = nn.Sequential(
            LayerNorm(hidden_dim),
            Dense(hidden_dim, hidden_dim * 2, use_bias=False),
            GELU(),
            Dense(hidden_dim * 2, out_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.to_in(x)
        pool_dims = tuple(range(2, x.dim() - 1))
        if pool_dims:  # the f32 sum times f32(1 / count), rounded once: XLA's mean
            # (e.g. fused_computation.35 of the 12x24 block multiplies by
            # 0.0416666679); torch's bf16 mean divides, which differs
            count = math.prod(x.shape[d] for d in pool_dims)
            x = (x.float().sum(dim=pool_dims) * (1.0 / count)).to(x.dtype)
        return self.out_ffn(x)


def _fab_impl_for(dim: int, dim_head: int) -> str:
    """The JAX package's choice of FAB core (``lns_tpu.ops.factorized_attention.
    _fab_impl_for``, without its benchmarking override): the c-space core
    touches a heads x dim wide tensor in 5 passes, the d-space core a
    heads x dim_head wide one in 9, so c-space iff 5 dim < 9 dim_head."""
    return "batchedgram" if 5 * dim < 9 * dim_head else "batched"


def _fold_norm(x_sum, x_sq, n_px: int, w_o1, dt, eps: float):
    """The InstanceNorm folded into the out-projection, as
    ``FABlock2D._batched_core``: from the f32 sums of x and of f32(x)**2 over
    the n_px pixels per (b, n, d), ``mean``, ``sq`` (each sum divided by
    n_px, as ``jnp.mean``), ``inv = rsqrt(max(sq - mean**2, 0) + eps)``, then
    ``wp = inv W_o1`` [b, n, d, o] and ``bias = (mean inv) @ W_o1`` [b, o],
    each rounded to dt."""
    mean, sq = x_sum / n_px, x_sq / n_px
    inv = torch.rsqrt((sq - mean.square()).clamp_min(0.0) + eps)
    w1f = w_o1.float()                                         # [n, d, o]
    wp = (inv[..., None] * w1f[None]).to(dt)
    bias = torch.einsum("bnd,ndo->bo", mean * inv, w1f).to(dt)
    return wp, bias


def fab_dspace_core_plain(u, k_x, k_y, w_in, w_o1, eps: float = 1e-5):
    """Plain PyTorch version of the d-space core, line for line the JAX
    package's ``FABlock2D._batched_core``: u [b, h, w, c], k_x [b, n, h, h],
    k_y [b, n, w, w], w_in [c, n, d], w_o1 [n, d, o] -> [b, h, w, o] in u's
    dtype. phi and both applies are rounded to u's dtype; the InstanceNorm
    folds into per-sample out-projection weights (``_fold_norm``), so the
    normalised value is never formed."""
    dt = u.dtype
    k_x, k_y, w_in = k_x.to(dt), k_y.to(dt), w_in.to(dt)
    _, h, w, _ = u.shape
    phi = torch.einsum("bhwc,cnd->bhwnd", u, w_in)
    x = torch.einsum("bnih,bhwnd->bniwd", k_x, phi)
    x = torch.einsum("bnlw,bniwd->bnlid", k_y, x)
    stats = axial_stats_plain(x)  # the sums over (l, i) per (b, n, d)
    wp, bias = _fold_norm(stats[..., 0], stats[..., 1], h * w, w_o1, dt, eps)
    out = torch.einsum("bnlid,bndo->blio", x, wp) - bias[:, None, None, :]
    return out.transpose(1, 2)


def fab_dspace_core(u, k_x, k_y, w_in, w_o1, eps: float = 1e-5):
    """The d-space core through kernel 4, rounding where the plain version
    (``_batched_core``) rounds: in_proj to the value phi [b, h, w, n, d] (a
    plain product, as in the JAX package, in its own layout); the rows
    apply, then the columns apply, each rounded, with the f32 sums of x and
    f32(x)**2 per (b, n, d) taken from the rounded x
    (``fab_axial_in_fused`` with the norm off and ``stats=True``: the kernel
    on a CUDA tensor); the norm folded into wp and the bias
    (``_fold_norm``); out_fc1 summed over heads as one plain product of the
    un-normalised x with wp, minus the bias. Shapes as
    ``fab_dspace_core_plain``."""
    dt = u.dtype
    _, h, w, _ = u.shape
    phi = torch.einsum("bhwc,cnd->bhwnd", u, w_in.to(dt))  # heads last: one product, no copy
    x, stats = fab_axial_in_fused(k_x.to(dt), k_y.to(dt), phi, with_instance_norm=False,
                                  stats=True, heads_last=True)
    wp, bias = _fold_norm(stats[..., 0], stats[..., 1], h * w, w_o1, dt, eps)
    return torch.einsum("bhwnd,bndo->bhwo", x, wp) - bias[:, None, None, :]


class FABlock2D(nn.Module):
    """Factorized attention block (reference: factorized_attention.py:97-160):
    GN(1) input norm -> pooled per-row / per-column descriptors -> two
    LowRankKernels k_x (h x h), k_y (w x w) -> FAB core (axial applications,
    InstanceNorm, out_fc1, head sum; c-space or d-space by
    ``_fab_impl_for``) -> GELU -> out_fc2, residual.

    ``use_kernel=False`` runs the core's plain version on any device."""

    def __init__(self, dim: int, dim_head: int, latent_dim: int, heads: int, dim_out: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.dim_out = dim_out
        self.in_norm = GroupNorm(1, dim, eps=1e-5)
        self.in_proj = Conv1x1(dim, heads * dim_head, use_bias=False)
        self.to_in = nn.Sequential(Conv1x1(dim, dim, use_bias=False))
        self.to_x = nn.Sequential(PoolingReducer(dim, dim, latent_dim))
        self.to_y = nn.Sequential(nn.Identity(), PoolingReducer(dim, dim, latent_dim))
        kd = dim_head * 2  # the reference's kernel_multiplier, 2 in every shipped config
        self.low_rank_kernel_x = LowRankKernel(latent_dim, kd, heads, use_rotary_emb=True)
        self.low_rank_kernel_y = LowRankKernel(latent_dim, kd, heads, use_rotary_emb=True)
        self.to_out = nn.Sequential(
            nn.Identity(),  # the reference's InstanceNorm2d, folded into the core
            Conv1x1(heads * dim_head, dim_out, use_bias=False),
            GELU(),
            Conv1x1(dim_out, dim_out, use_bias=False),
        )
        self.impl = _fab_impl_for(dim, dim_head)
        self.use_kernel = True

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        u_skip = u
        low = u.dtype != torch.float32 and self.impl == "batchedgram"
        un = self.in_norm(u, with_coef=low)
        un, coef = un if low else (un, None)
        un = un.movedim(1, -1)  # [b, h, w, c]
        c = un.shape[-1]
        w_in = self.in_proj.weight[:, :, 0, 0].t().reshape(c, self.heads, self.dim_head)
        u_in = self.to_in[0].forward_last(un)
        u_x = self.to_x[0](u_in)                  # per-row descriptors
        u_y = self.to_y[1](u_in.transpose(1, 2))  # per-column descriptors
        k_x, kx_s = self.low_rank_kernel_x.kernel_and_sums(u_x)  # [b, heads, h, h]
        k_y, ky_s = self.low_rank_kernel_y.kernel_and_sums(u_y)  # [b, heads, w, w]
        w_o1 = self.to_out[1].weight[:, :, 0, 0].t().reshape(
            self.heads, self.dim_head, self.dim_out)
        if self.impl == "batchedgram":
            # bf16: the core's mean_c as the jitted JAX block computes it
            # (its optimised HLO on the CPU, dim 32 at 16x16): the column
            # sums of the kernels from the f32 products before their bf16
            # round (wrapped_reduce.1 / .2 read dot_general.35 / .38; the
            # applies read the rounded convert_convert_fusion.6), and the
            # GroupNorm(1) output before its round (the mean_c dot reads
            # add_bitcast_fusion; to_in and the applies read the rounded
            # convert_bitcast_fusion.8 / copy_bitcast_fusion.11). The core
            # forms it from the block's input, the GroupNorm's sc and sh and
            # the f32 sums (block_mean_c).
            mean_from = (u.movedim(1, -1), coef, kx_s, ky_s) if low else None
            core = fab_fused_core if self.use_kernel else fab_core_plain
            out = core(un.contiguous(), k_x, k_y, w_in, w_o1, mean_from=mean_from)
        else:
            core = fab_dspace_core if self.use_kernel else fab_dspace_core_plain
            out = core(un.contiguous(), k_x, k_y, w_in, w_o1)
        out = self.to_out[3].forward_last(gelu(out))
        return out.movedim(-1, 1) + u_skip
