"""Pre-LN multi-head self-attention (reference: modules/basics.py:331-404).

The decoder runs it on the coarse latent grid (64 tokens on NS2d), so a
plain batched QK^T einsum and softmax is all it needs.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = x.dim() == 4
        if spatial:
            b, c, hh, ww = x.shape
            x = x.movedim(1, -1).reshape(b, hh * ww, c)
        n = x.shape[1]
        h = self.ln(x)
        if self.pe is not None:
            h = h + self.pe[:, :n].to(h.dtype)
        q, k, v = (self._split(f(h)) for f in (self.to_q, self.to_k, self.to_v))
        attn = softmax_last(torch.einsum("bhid,bhjd->bhij", q, k), self.dim_head ** -0.5)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        out = out.transpose(1, 2).reshape(out.shape[0], n, -1)
        out = x + self.proj_out(out)
        if spatial:
            out = out.reshape(b, hh, ww, c).movedim(-1, 1)
        return out
