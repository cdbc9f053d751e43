"""GroupNorm(G) + affine + optional swish: a CUDA C++ kernel for Hopper
(``csrc/group_norm.cu``; design notes there).

Replaces ``lns_tpu/pallas_kernels/group_norm.py: fused_group_norm_swish``
(``_gn_kernel``), and computes what the JAX package's models run:
``lns_tpu.ops.norms.GroupNorm`` (including its ``max(var, 0)`` clamp, which
the TPU kernel lacks) followed by ``lns_tpu.ops.activations.swish``, at their
rounding points (``group_norm_swish_plain`` states them).

What bounds it on an H100: bytes. Each element is read and written once;
the arithmetic per byte is far below the card's ratio of compute to
bandwidth. The main path calls it at every GroupNorm site: GN(32) eps 1e-6
(+swish) from 64x64 down to 8x8 at C = 64/128, GN(8) eps 1e-5 + swish at
64x64x64, and GN(1) eps 1e-5 without swish (the FAB ``in_norm``) at 16x16
and 32x32 x64.

Design: one thread-block cluster of 1-8 blocks per sample. Each block holds
a run of the sample's rows in shared memory (one HBM read), the blocks
exchange per-group f32 partial sums through distributed shared memory and
add them in rank order (f32 exchanges twice, for the exact two-pass
variance), then normalise from shared memory (one HBM write). A slab that a
cluster of 8 cannot hold (SW's 96x192x64 fields) takes the split plan: x
read twice, per-group partials of each chunk of rows written to a workspace
that this wrapper allocates, added in chunk order (f32 takes a second,
centred pass), then a normalising pass; any S.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.ops.activations import swish
from lns_tpu_torch.utils import profiling

# the C entry points' dtype argument
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


_SUM_ROWS = 1024


def _group_sums(t):
    """Sums of t [B, S, G, C/G] over (S, C/G) per (sample, group), f32: in
    runs of at most _SUM_ROWS rows, then over the runs (a single run over
    SW's 18,432 rows loses ~1e-6 relative to the order the JAX package's
    reduction takes)."""
    b, s, g, cg = t.shape
    if s <= _SUM_ROWS:
        return t.sum(dim=(1, 3))
    t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, (-s) % _SUM_ROWS))
    return t.reshape(b, -1, _SUM_ROWS, g, cg).sum(dim=(2, 4)).sum(dim=1)


def group_norm_swish_plain(x, scale, bias, num_groups: int, eps: float = 1e-6,
                           apply_swish: bool = True, with_coef: bool = False):
    """Plain PyTorch version: x [B, *spatial, C] -> same shape and dtype,
    rounded where ``lns_tpu.ops.norms.GroupNorm`` and
    ``lns_tpu.ops.activations.swish`` round.

    f32 (``norms.py:45-54``): two-pass statistics, mean then the centred
    variance; normalise, affine and swish in f32.

    bf16 and f16 (``norms.py:55-76``):
      * f32 single-pass sums of x and x**2 per (sample, group);
      * ``var = max(E[x**2] - mean**2, 0)``, ``inv = rsqrt(var + eps)``;
      * ``sc = inv * scale`` and ``sh = bias - mean * sc`` in f32, each
        rounded to the activation dtype;
      * ``y = x * sc + sh`` in the activation dtype: the product rounded,
        then the sum;
      * swish as ``y * (1 / (1 + exp(-y)))``, each op rounded to the
        activation dtype (``ops.activations.swish``, what XLA computes for
        ``y * sigmoid(y)``).

    ``with_coef`` (bf16 / f16): also each sample's sc and sh [B, 2, C], the
    rounded values as f32 (the FAB core reads them).
    """
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, num_groups, cg)
    if x.dtype == torch.float32:
        if with_coef:
            raise ValueError("group_norm_swish_plain: with_coef takes bf16 or f16")
        n = xf.shape[1] * cg
        mean = (_group_sums(xf) / n)[:, None, :, None]
        var = (_group_sums((xf - mean).square()) / n)[:, None, :, None].clamp_min(0.0)
        y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, -1, c)
        y = y * scale.float() + bias.float()
        return (swish(y) if apply_swish else y).reshape(x.shape)
    n = xf.shape[1] * cg  # sums divided by n, as jnp.mean (torch's CUDA mean multiplies by 1/n)
    mean = _group_sums(xf) / n                                     # [B, G]
    var = (_group_sums(xf.square()) / n - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    sc = inv.repeat_interleave(cg, dim=1) * scale.float()          # [B, C]
    sh = bias.float() - mean.repeat_interleave(cg, dim=1) * sc
    sc, sh = sc.to(x.dtype), sh.to(x.dtype)
    y = x.reshape(b, -1, c) * sc[:, None] + sh[:, None]
    y = (swish(y) if apply_swish else y).reshape(x.shape)
    return (y, torch.stack([sc, sh], 1).float()) if with_coef else y


@functools.lru_cache(maxsize=None)
def _limit(code: int, b: int, s: int, c: int, groups: int):
    """The C side's statement of the kernel's limits for this shape: None
    when the kernel takes it, else the limit it breaks."""
    msg = _build.library().lns_group_norm_limit(code, b, s, c, groups)
    return msg.decode() if msg else None


@functools.lru_cache(maxsize=None)
def _workspace_bytes(code: int, b: int, s: int, c: int, groups: int) -> int:
    """Bytes of the split plan's workspace for this shape (0 for the
    one-pass kernel), as the C side computes them."""
    return int(_build.library().lns_group_norm_workspace(code, b, s, c, groups))


class GroupNormSwishFunction(torch.autograd.Function):
    """Kernel 3 with a gradient. The forward launches the kernel (the plain
    version for a CPU tensor) and saves x, scale and bias; the backward
    recomputes ``group_norm_swish_plain`` from them under grad and returns
    that function's gradients. The JAX package has no backward kernel to
    port (XLA differentiates ``norms.GroupNorm``), so none is written here;
    the gradient is the plain version's, in its layout and dtypes. The
    coefficients of ``with_coef`` carry none (the FAB core reads them for a
    rounding residue whose gradient is zero)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, apply_swish: bool,
                with_coef: bool = False):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_swish)
        out = _group_norm_swish(x, scale, bias, num_groups, eps, apply_swish, with_coef)
        if with_coef:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, grad, *_):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = group_norm_swish_plain(*inputs, *ctx.args)
        grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], grad))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 4


def fused_group_norm_swish(x, scale, bias, num_groups: int, eps: float = 1e-6,
                           apply_swish: bool = True, with_coef: bool = False):
    """GroupNorm (+swish) on x [B, *spatial, C] (contiguous, channels last).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises (for a shape outside the kernel's
    limits, with the text of the C side's ``lns_group_norm_limit``, before
    any launch). With grad mode on and x, scale or bias requiring grad the
    call goes through ``GroupNormSwishFunction``, which launches the same
    kernel and carries the plain version's gradient. ``with_coef`` (bf16 /
    f16): (y, each sample's sc and sh [B, 2, C] f32), as
    ``group_norm_swish_plain``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormSwishFunction.apply(x, scale, bias, num_groups, eps, apply_swish,
                                            with_coef)
    return _group_norm_swish(x, scale, bias, num_groups, eps, apply_swish, with_coef)


def _group_norm_swish(x, scale, bias, num_groups: int, eps: float, apply_swish: bool,
                      with_coef: bool = False):
    """The launch (or, for a CPU tensor, the plain version), without grad."""
    t0 = profiling.clock()
    if not _build.on_cuda(x, "fused_group_norm_swish", scale, bias):
        return group_norm_swish_plain(x, scale, bias, num_groups, eps, apply_swish, with_coef)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_group_norm_swish: unsupported dtype {x.dtype}")
    if with_coef and x.dtype == torch.float32:
        raise ValueError("fused_group_norm_swish: with_coef takes bf16 or f16")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm_swish: x must be contiguous [B, *spatial, C]")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"fused_group_norm_swish: {name} must be contiguous f32 [{c}] on {x.device}")
    b, s = x.shape[0], math.prod(x.shape[1:-1])
    code = _DTYPE_CODE[x.dtype]
    limit = _limit(code, b, s, c, num_groups)
    if limit:
        raise ValueError(f"fused_group_norm_swish: {str(x.dtype)[6:]} at B{b} S{s} C{c} "
                         f"G{num_groups} needs {limit}")
    xk = x if x.data_ptr() % 16 == 0 else x.clone()  # read as 16-byte vectors
    out = torch.empty_like(x)
    coef = torch.empty((b, 2, c), device=x.device) if with_coef else None
    ws_bytes = _workspace_bytes(code, b, s, c, num_groups)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device) if ws_bytes else None
    rc = _build.library().lns_group_norm(
        code, xk.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if coef is None else coef.data_ptr(),
        b, s, c, num_groups, float(eps),
        int(bool(apply_swish)), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"lns_group_norm(B={b}, S={s}, C={c}, G={num_groups})")
    profiling.launched("group_norm.fused_group_norm_swish",
                       ws_bytes + _build.copy_bytes((x, xk)), t0)
    return (out, coef) if with_coef else out


def group_norm_plan(dtype: torch.dtype, b: int, s: int, c: int, groups: int) -> dict:
    """The kernel's launch for a shape (needs the card): blocks per sample
    (the cluster; 1 in the split plan), blocks, shared memory bytes per
    block, the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``), rows of the slab per block, and
    chunks per sample (0 for the one-pass kernel; the split plan's blocks
    take one chunk each)."""
    res = (ctypes.c_int * 6)()
    _build.check(_build.library().lns_group_norm_plan(_DTYPE_CODE[dtype], b, s, c, groups, res),
                 "lns_group_norm_plan")
    return dict(zip(("cluster", "blocks", "smem_bytes", "max_active_clusters", "rows_per_block",
                     "chunks"), res))
