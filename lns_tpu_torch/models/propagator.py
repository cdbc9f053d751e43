"""Latent-space propagators: ``SimpleCNN`` with ``DilatedResidualBlock``s
(reference: train_stage2_ns2d.py:25-87), circular padding on NS2d,
half-periodic-x on SW (train_stage2_SW.py) and zeros on the two-phase
family (train_stage2_twophase.py); and ``CondSimpleCNN`` with
``CondDilatedResidualBlock``s, the conditional two-phase family's, which
conditions each step on a scalar parameter through FiLM
(train_stage2_twophase_conditional.py:25-121). A half-periodic conv rounds
as ``ops.conv.ConvND`` states (the JAX module step's rounding points); the
fused rollout kernel sums the nine taps in one accumulator, as the JAX
package's Pallas rollout does.

Checkpoint names follow the reference trainers: ``in_proj``,
``net.{i}.conv.{0,1,3,5}``, ``net.{i}.ffn.{0,1,3}``, ``out_proj.{0.gn,1}``;
the conditional model ``cond_emb_proj.{0,2}``, ``net.{i}.cond_emb``,
``net.{i}.conv1.{0,1,3}``, ``net.{i}.cond_conv1.{0,2}``,
``net.{i}.cond_conv2.{0,1,3}`` and ``net.{i}.ffn.{0,1,3}``. ``forward``
takes and returns NHWC latents [B, H, W, C]; the fused rollout kernel
(``kernels.prop_rollout``) runs many steps of the SimpleCNN. The library
propagators ``SimpleResNet``, ``SimpleMLP`` and ``ConditionalResNet``
(dead code in the reference, options in the JAX package) follow.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from lns_tpu_torch.ops.activations import GELU, gelu, swish
from lns_tpu_torch.ops.attention import CABlock, SABlock
from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
from lns_tpu_torch.ops.embedding import fourier_embedding
from lns_tpu_torch.ops.initializers import zero_init
from lns_tpu_torch.ops.norms import GroupNorm, GroupNormWrapper
from lns_tpu_torch.ops.resblocks import ResidualBlock


class DilatedResidualBlock(nn.Module):
    """GN(1) -> conv3 -> GELU -> dilated conv3 -> GELU -> conv3, residual;
    then GN(1) -> 1x1 -> GELU -> 1x1, residual."""

    def __init__(self, dim: int, dilation: int = 1, padding_mode: str = "circular",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def conv3(dil):
            return ConvND(dim, dim, 3, padding=dil, dilation=dil,
                          padding_mode=padding_mode, dtype=dtype)

        self.conv = nn.Sequential(GroupNorm(1, dim, eps=1e-5), conv3(1), GELU(),
                                  conv3(dilation), GELU(), conv3(1))
        self.ffn = nn.Sequential(GroupNorm(1, dim, eps=1e-5),
                                 Conv1x1(dim, dim, use_bias=False, dtype=dtype), GELU(),
                                 Conv1x1(dim, dim, use_bias=False, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.conv[1](self.conv[0](x)))
        h = gelu(self.conv[3](h))
        x = x + self.conv[5](h)
        f = gelu(self.ffn[1](self.ffn[0](x)))
        return x + self.ffn[3](f)


class SimpleCNN(nn.Module):
    """1x1 in_proj -> n DilatedResidualBlocks -> GN(32) + 1x1 out_proj;
    predicts the next latent state directly."""

    def __init__(self, latent_dim: int, prop_n_block: int, prop_n_embd: int,
                 dilation: int = 2, padding_mode: str = "circular",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.prop_n_block = prop_n_block
        self.dilation = dilation
        self.padding_mode = padding_mode
        self.in_proj = Conv1x1(latent_dim, prop_n_embd, dtype=dtype)
        self.net = nn.Sequential(*[
            DilatedResidualBlock(prop_n_embd, dilation, padding_mode, dtype)
            for _ in range(prop_n_block)])
        self.out_proj = nn.Sequential(GroupNormWrapper(prop_n_embd, 32, 1e-6),
                                      Conv1x1(prop_n_embd, latent_dim, dtype=dtype))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """One step: z [B, H, W, C_lat] -> [B, H, W, C_lat]."""
        h = self.net(self.in_proj(z.permute(0, 3, 1, 2)))
        return self.out_proj(h).permute(0, 2, 3, 1)


# a block's conditioning: its embedding's projection and its FiLM scale,
# each [B, dim] f32
BlockCond = Tuple[torch.Tensor, torch.Tensor]


class CondDilatedResidualBlock(nn.Module):
    """GN(1) -> conv3 -> GELU -> dilated conv3, plus the block's projection
    of the conditioning embedding; GN(1) -> GELU -> a zero-initialised conv3
    gate, residual; then the FFN of the input scaled by ``1 + c``, c the
    FiLM scale (GN(1) -> 1x1 -> GELU -> a zero-initialised 1x1 of the
    projection), residual (``lns_tpu.models.propagator.CondDilatedResidualBlock``).

    The projection and the FiLM branch take no dtype, as in the JAX block:
    they follow the f32 embedding. So with a bf16 block ``h + emb`` and
    ``x (1 + c)`` promote to f32, and ``cond_conv1``'s GroupNorm and GELU
    and ``ffn``'s GroupNorm run in f32 before ``cond_conv1`` and ``ffn.1``
    cast back to the block's dtype. Both depend on the parameter alone:
    ``conditioning`` computes them once, ``forward`` takes them.

    Rounding, as the jitted JAX block computes it (its optimised HLO on the
    CPU): the product of ``conv1.3`` and its bias are each rounded to the
    block's dtype and summed in f32 with no rounding before ``emb`` is
    added (the fusion that adds ``emb`` recomputes the sum); ``x +
    cond_conv1(...)`` is rounded where it is the block's residual and read
    unrounded, in f32, by the FiLM product."""

    def __init__(self, dim: int, cond_emb_dim: int, dilation: int = 1,
                 padding_mode: str = "zeros", dtype: Optional[torch.dtype] = None):
        super().__init__()

        def conv3(dil):
            return ConvND(dim, dim, 3, padding=dil, dilation=dil, padding_mode=padding_mode,
                          dtype=dtype)

        self.cond_emb = Dense(cond_emb_dim, dim)
        self.conv1 = nn.Sequential(GroupNorm(1, dim, eps=1e-5), conv3(1), GELU(),
                                   conv3(dilation))
        self.cond_conv1 = nn.Sequential(GroupNorm(1, dim, eps=1e-5), GELU(), zero_init(conv3(1)))
        self.cond_conv2 = nn.Sequential(GroupNorm(1, dim, eps=1e-5), Conv1x1(dim, dim), GELU(),
                                        zero_init(Conv1x1(dim, dim)))
        self.ffn = nn.Sequential(GroupNorm(1, dim, eps=1e-5),
                                 Conv1x1(dim, dim, use_bias=False, dtype=dtype), GELU(),
                                 Conv1x1(dim, dim, use_bias=False, dtype=dtype))

    def conditioning(self, emb: torch.Tensor) -> BlockCond:
        """emb [B, cond_emb_dim] f32 -> (the projection, the FiLM scale c),
        each [B, dim] f32; c's GroupNorm runs over one row per sample."""
        e = self.cond_emb(emb)
        c = self.cond_conv2[0](e[:, :, None, None])
        c = self.cond_conv2[3](gelu(self.cond_conv2[1](c)))
        return e, c[:, :, 0, 0]

    def forward(self, x: torch.Tensor, cond: BlockCond) -> torch.Tensor:
        e, c = cond
        conv = self.conv1[3]
        h = conv.product(gelu(self.conv1[1](self.conv1[0](x))))
        h = h.float() + conv.bias.to(h.dtype).float()[:, None, None] + e[:, :, None, None]
        g = self.cond_conv1[2](gelu(self.cond_conv1[0](h)))
        f = self.ffn[0]((x.float() + g.float()) * (1 + c[:, :, None, None]))
        return (x + g) + self.ffn[3](gelu(self.ffn[1](f)))


class CondSimpleCNN(nn.Module):
    """The scalar parameter's Fourier embedding -> a 2-layer GELU MLP; 1x1
    in_proj -> n CondDilatedResidualBlocks, each conditioned on that
    embedding -> GN(32) + 1x1 out_proj (``lns_tpu.models.propagator.CondSimpleCNN``).

    ``conditioning(param)`` computes what depends on the parameter alone
    (the embedding, its MLP, each block's projection and FiLM scale) and
    ``step(z, cond)`` one step from it, so a rollout computes it once;
    ``forward(z, param)`` is the two in one, the JAX module's call."""

    def __init__(self, latent_dim: int, cond_emb_dim: int, prop_n_block: int, prop_n_embd: int,
                 dilation: int = 2, padding_mode: str = "zeros",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cond_emb_dim = cond_emb_dim
        self.prop_n_block = prop_n_block
        self.dilation = dilation
        self.padding_mode = padding_mode
        self.in_proj = Conv1x1(latent_dim, prop_n_embd, dtype=dtype)
        self.cond_emb_proj = nn.Sequential(Dense(cond_emb_dim, cond_emb_dim), GELU(),
                                           Dense(cond_emb_dim, cond_emb_dim))
        self.net = nn.ModuleList([
            CondDilatedResidualBlock(prop_n_embd, cond_emb_dim, dilation, padding_mode, dtype)
            for _ in range(prop_n_block)])
        self.out_proj = nn.Sequential(GroupNormWrapper(prop_n_embd, 32, 1e-6),
                                      Conv1x1(prop_n_embd, latent_dim, dtype=dtype))

    def conditioning(self, param: torch.Tensor) -> List[BlockCond]:
        """param [B] -> each block's (projection, FiLM scale)."""
        emb = self.cond_emb_proj(fourier_embedding(param, self.cond_emb_dim))
        return [block.conditioning(emb) for block in self.net]

    def step(self, z: torch.Tensor, cond: List[BlockCond]) -> torch.Tensor:
        """One step: z [B, H, W, C_lat] -> [B, H, W, C_lat]."""
        h = self.in_proj(z.permute(0, 3, 1, 2))
        for block, c in zip(self.net, cond):
            h = block(h, c)
        return self.out_proj(h).permute(0, 2, 3, 1)

    def forward(self, z: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
        return self.step(z, self.conditioning(param))


# -- the library propagators (reference: modules/propagator.py; the JAX
# package's lns_tpu/models/propagator.py:179-252). Each takes and returns
# NHWC latents; parameters live under the JAX package's module names.

class SimpleResNet(nn.Module):
    """1x1 in_proj -> swish -> conv3 ``stem`` -> GN(32) ``gn_in`` -> three
    ``ResidualBlock``s ``res{i}`` -> GN(32)+swish ``gn_out`` -> 1x1
    ``out_proj``; circular padding when ``is_periodic``, else zeros."""

    def __init__(self, latent_dim: int, propagator_dim: int, is_periodic: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pm = "circular" if is_periodic else "zeros"
        self.in_proj = Conv1x1(latent_dim, propagator_dim, dtype=dtype)
        self.stem = ConvND(propagator_dim, propagator_dim, 3, padding=1, padding_mode=pm,
                           dtype=dtype)
        self.gn_in = GroupNorm(32, propagator_dim, eps=1e-6)
        for i in range(3):
            self.add_module(f"res{i}", ResidualBlock(propagator_dim, propagator_dim, pm, dtype))
        self.gn_out = GroupNorm(32, propagator_dim, eps=1e-6)
        self.out_proj = Conv1x1(propagator_dim, latent_dim, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.gn_in(self.stem(swish(self.in_proj(z.permute(0, 3, 1, 2)))))
        for i in range(3):
            h = getattr(self, f"res{i}")(h)
        return self.out_proj(self.gn_out(h, apply_swish=True)).permute(0, 2, 3, 1)


class SimpleMLP(nn.Module):
    """The latent flattened in H W C order (the NHWC latent's own) -> Dense
    ``fc1`` -> swish -> ``fc2`` -> swish -> ``fc3``, added to the flattened
    latent (a residual update)."""

    def __init__(self, latent_dim: int, latent_resolution: int, propagator_dim: int):
        super().__init__()
        n = latent_resolution * latent_resolution * latent_dim
        self.fc1 = Dense(n, propagator_dim)
        self.fc2 = Dense(propagator_dim, propagator_dim)
        self.fc3 = Dense(propagator_dim, n)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        flat = z.reshape(z.shape[0], 1, -1)
        d = self.fc3(swish(self.fc2(swish(self.fc1(flat)))))
        return (flat + d).reshape(z.shape)


class ConditionalResNet(nn.Module):
    """1x1 in_proj, then per block an ``SABlock`` ``sa{i}`` (no positional
    embedding; when ``use_self_attn``), a ``CABlock`` ``ca{i}`` on the
    context tokens [B, M, context_dim] and a ``ResidualBlock`` ``res{i}``;
    GN(32)+swish ``gn_out`` -> 1x1 ``out_proj``."""

    def __init__(self, latent_dim: int, propagator_dim: int, context_dim: int,
                 n_blocks: int = 3, heads: int = 8, dim_head: int = 64,
                 use_self_attn: bool = True, is_periodic: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pm = "circular" if is_periodic else "zeros"
        self.n_blocks, self.use_self_attn = n_blocks, use_self_attn
        self.in_proj = Conv1x1(latent_dim, propagator_dim, dtype=dtype)
        for i in range(n_blocks):
            if use_self_attn:
                self.add_module(f"sa{i}", SABlock(propagator_dim, heads, dim_head))
            self.add_module(f"ca{i}", CABlock(propagator_dim, context_dim, heads, dim_head))
            self.add_module(f"res{i}", ResidualBlock(propagator_dim, propagator_dim, pm, dtype))
        self.gn_out = GroupNorm(32, propagator_dim, eps=1e-6)
        self.out_proj = Conv1x1(propagator_dim, latent_dim, dtype=dtype)

    def forward(self, z: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.in_proj(z.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            if self.use_self_attn:
                h = getattr(self, f"sa{i}")(h)
            h = getattr(self, f"res{i}")(getattr(self, f"ca{i}")(h, context))
        return self.out_proj(self.gn_out(h, apply_swish=True)).permute(0, 2, 3, 1)


# the SimpleCNN's padding per workload (lns_tpu/models/propagator.py:256)
PADDING = {"ns2d": "circular", "sw": "half_periodic_x", "twophase": "zeros"}


def build_propagator(cfg, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The stage-2 propagator of a config: a SimpleCNN, circular on NS2d,
    half-periodic in x on SW, zero-padded on the two-phase family; a
    zero-padded CondSimpleCNN on the conditional two-phase family, its
    embedding ``latent_dim`` wide, as the JAX package builds it
    (``lns_tpu/models/propagator.py:258-266``)."""
    if cfg.is_conditional:
        return CondSimpleCNN(cfg.latent_dim, cfg.latent_dim, cfg.prop_n_block, cfg.prop_n_embd,
                             dilation=cfg.dilation, padding_mode="zeros", dtype=dtype)
    return SimpleCNN(cfg.latent_dim, cfg.prop_n_block, cfg.prop_n_embd,
                     dilation=cfg.dilation, padding_mode=PADDING[cfg.workload], dtype=dtype)
