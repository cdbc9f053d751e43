"""Pre-LN multi-head self-attention, its linear (no softmax) variant and
cross-attention (reference: modules/basics.py:331-528).

The decoder runs self-attention on the coarse latent grid (64 tokens on
NS2d), and the library blocks run on latent grids too, so a plain batched
QK^T einsum and softmax is all they need.
"""

from __future__ import annotations

import torch
from torch import nn

from lns_tpu_torch.ops.conv import Dense
from lns_tpu_torch.ops.norms import LayerNorm


def softmax_last(a: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(a * scale) over the last dim. bf16 / f16 round where the
    JAX package's ``jax.nn.softmax(a * scale)`` rounds under ``jax.jit``
    (measured against it, ``tests/test_torch_port_bf16.py``): the scale as
    a constant of a's dtype, s = a * scale and s - max(s) rounded, exp in
    f32, the f32 sum of the unrounded exps rounded, then
    ``bf16(exp) / bf16(sum)`` rounded."""
    if a.dtype not in (torch.bfloat16, torch.float16):
        return (a * scale).softmax(dim=-1)
    s = a * float(torch.tensor(scale, dtype=a.dtype))
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)).float())
    return e.to(a.dtype) / e.sum(dim=-1, keepdim=True).to(a.dtype)


def _tokens(x: torch.Tensor):
    """x [B, C, H, W] -> ([B, H W, C] row-major tokens, (H, W)); a token
    sequence [B, N, C] passes through with None."""
    if x.dim() == 3:
        return x, None
    b, c, hh, ww = x.shape
    return x.movedim(1, -1).reshape(b, hh * ww, c), (hh, ww)


def _spatial(t: torch.Tensor, hw) -> torch.Tensor:
    if hw is None:
        return t
    return t.reshape(t.shape[0], hw[0], hw[1], t.shape[-1]).movedim(-1, 1)


class SABlock(nn.Module):
    """Self-attention over the row-major tokens of x [B, C, H, W] (or a
    token sequence [B, N, C]), optional learnable positional embedding of
    length ``block_size``, residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, use_pe: bool = False,
                 block_size: int = 512):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hd = heads * dim_head
        self.ln = LayerNorm(dim)
        self.pe = nn.Parameter(torch.zeros(1, block_size, dim)) if use_pe else None
        self.to_q = Dense(dim, hd, use_bias=False)
        self.to_k = Dense(dim, hd, use_bias=False)
        self.to_v = Dense(dim, hd)
        self.proj_out = Dense(hd, dim)

    def _split(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def _weights(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return softmax_last(torch.einsum("bhid,bhjd->bhij", q, k), self.dim_head ** -0.5)

    def _attend(self, hq: torch.Tensor, hkv: torch.Tensor) -> torch.Tensor:
        q = self._split(self.to_q(hq))
        k, v = self._split(self.to_k(hkv)), self._split(self.to_v(hkv))
        out = torch.einsum("bhij,bhjd->bhid", self._weights(q, k), v)
        return self.proj_out(out.transpose(1, 2).reshape(out.shape[0], hq.shape[1], -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, hw = _tokens(x)
        h = self.ln(x)
        if self.pe is not None:
            h = h + self.pe[:, :x.shape[1]].to(h.dtype)
        return _spatial(x + self._attend(h, h), hw)


class LABlock(SABlock):
    """``SABlock`` without the softmax: the scaled QK^T weighs V as it is
    (reference: modules/basics.py:407-478); the residual adds the tokens
    before the LayerNorm."""

    def _weights(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        a = torch.einsum("bhid,bhjd->bhij", q, k)
        return a * float(torch.tensor(self.dim_head ** -0.5, dtype=a.dtype))  # a's constant


class CABlock(SABlock):
    """Cross-attention: queries from the field x [B, C, H, W] (or tokens
    [B, N, C]), keys and values from context tokens y [B, M, context_dim],
    each LayerNorm'd (``ln_x``, ``ln_y``); the residual adds the
    *normalised* query, as the JAX block has it, and the output takes x's
    layout back (reference: modules/basics.py:481-528). Projections keep
    the Linear default init."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__(dim, heads, dim_head)
        del self.ln
        hd = heads * dim_head
        self.ln_x = LayerNorm(dim)
        self.ln_y = LayerNorm(context_dim)
        self.to_k = Dense(context_dim, hd, use_bias=False)
        self.to_v = Dense(context_dim, hd)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, hw = _tokens(x)
        xq = self.ln_x(x)
        return _spatial(xq + self._attend(xq, self.ln_y(y)), hw)
