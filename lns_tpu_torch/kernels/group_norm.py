"""GroupNorm(G) + affine + optional swish: a Triton kernel for Hopper.

Replaces ``lns_tpu/pallas_kernels/group_norm.py: fused_group_norm_swish``
(``_gn_kernel``), held to ``lns_tpu.ops.norms.GroupNorm`` (including its
``max(var, 0)`` clamp, which the TPU kernel lacks).

What bounds it on an H100: bytes. Each element is read and written once by
the math; the arithmetic per byte is a few operations, far below the card's
ratio of compute to bandwidth. The main path calls it at every GroupNorm
site: GN(32) eps 1e-6 (+swish) from 64x64 down to 8x8 at C = 64/128,
GN(8) eps 1e-5 + swish at 64x64x64, and GN(1) eps 1e-5 without swish (the
FAB ``in_norm``) at 16x16 and 32x32 x64.

Design: one program per (sample, group) over the channels-last [B, S, C]
memory. The program walks its group's [S, C/G] slab three times (mean,
centred variance, normalise + affine + swish + store), all in f32, so the
statistics are the exact two-pass ones; the slab of one sample is at most a
few hundred KB and the second and third walks hit L2. Fusing the swish and
the affine into the store pass keeps the activation to one HBM read and one
write, which is the whole point of the TPU kernel as well.
"""

from __future__ import annotations

import torch

from lns_tpu_torch.kernels import _build

_KERNEL = None


def group_norm_swish_plain(x, scale, bias, num_groups: int, eps: float = 1e-6,
                           apply_swish: bool = True):
    """Plain PyTorch version: x [B, *spatial, C] -> same shape and dtype.
    f32 two-pass statistics; normalise, affine and swish in f32, one cast."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, -1, c)
    y = y * scale.float() + bias.float()
    if apply_swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def _gn_kernel(x_ptr, w_ptr, b_ptr, y_ptr, S, C, G, eps,
               CG: "tl.constexpr", BLOCK_S: "tl.constexpr",
               BLOCK_C: "tl.constexpr", APPLY_SWISH: "tl.constexpr"):
    pid = tl.program_id(0)
    b = pid // G
    g = pid % G
    base = b.to(tl.int64) * S * C + g * CG
    offs_s = tl.arange(0, BLOCK_S)
    offs_c = tl.arange(0, BLOCK_C)
    cmask = offs_c < CG
    n = S * CG

    acc = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    for s0 in range(0, S, BLOCK_S):
        s = s0 + offs_s
        m = (s < S)[:, None] & cmask[None, :]
        ptr = x_ptr + base + s[:, None] * C + offs_c[None, :]
        acc += tl.load(ptr, mask=m, other=0.0).to(tl.float32)
    mean = tl.sum(tl.sum(acc, axis=1), axis=0) / n

    acc = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    for s0 in range(0, S, BLOCK_S):
        s = s0 + offs_s
        m = (s < S)[:, None] & cmask[None, :]
        ptr = x_ptr + base + s[:, None] * C + offs_c[None, :]
        d = tl.where(m, tl.load(ptr, mask=m, other=0.0).to(tl.float32) - mean, 0.0)
        acc += d * d
    var = tl.maximum(tl.sum(tl.sum(acc, axis=1), axis=0) / n, 0.0)
    rstd = tl.rsqrt(var + eps)

    w = tl.load(w_ptr + g * CG + offs_c, mask=cmask, other=0.0).to(tl.float32)
    bb = tl.load(b_ptr + g * CG + offs_c, mask=cmask, other=0.0).to(tl.float32)
    for s0 in range(0, S, BLOCK_S):
        s = s0 + offs_s
        m = (s < S)[:, None] & cmask[None, :]
        off = base + s[:, None] * C + offs_c[None, :]
        v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        y = (v - mean) * rstd * w[None, :] + bb[None, :]
        if APPLY_SWISH:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)


def _triton_kernel():
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        # the kernel body resolves `tl` from this module's globals at compile
        globals()["tl"] = triton.language
        _KERNEL = triton.jit(_gn_kernel)
    return _KERNEL


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def fused_group_norm_swish(x, scale, bias, num_groups: int, eps: float = 1e-6,
                           apply_swish: bool = True):
    """GroupNorm (+swish) on x [B, *spatial, C] (contiguous, channels last).

    A CPU tensor takes the plain version; a CUDA tensor launches the Triton
    kernel on the current stream or raises."""
    if not _build.on_cuda(x, "fused_group_norm_swish"):
        return group_norm_swish_plain(x, scale, bias, num_groups, eps, apply_swish)
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"fused_group_norm_swish: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm_swish: x must be contiguous [B, *spatial, C]")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"fused_group_norm_swish: {name} must be contiguous f32 [{c}] on {x.device}")
    b = x.shape[0]
    s = x.numel() // (b * c)
    cg = c // num_groups
    block_c = _pow2(cg)
    block_s = min(_pow2(s), max(16, 2048 // block_c))
    out = torch.empty_like(x)
    _triton_kernel()[(b * num_groups,)](
        x, scale, bias, out, s, c, num_groups, float(eps),
        CG=cg, BLOCK_S=block_s, BLOCK_C=block_c, APPLY_SWISH=bool(apply_swish),
        num_warps=4,
    )
    fused_group_norm_swish.launches += 1
    return out


fused_group_norm_swish.launches = 0
