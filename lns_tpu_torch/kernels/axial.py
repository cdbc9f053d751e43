"""Head-major axial apply, with an optional InstanceNorm or its statistics,
as a CUDA C++ kernel for Hopper (``csrc/axial.cu``).

Replaces two TPU kernels with one source:

  * ``lns_tpu/pallas_kernels/axial_fused.py: fab_axial_in_fused``
    (``_fab_kernel``): rows first, then columns, then InstanceNorm over
    (H, W) per (sample, head, d). With the norm off and ``stats=True`` it
    carries the FAB block's d-space core (``FABlock2D._batched_core``,
    ``lns_tpu/ops/factorized_attention.py``; ``ops.factorized_attention.
    fab_dspace_core``), which folds the norm into its out-projection.
  * ``lns_tpu/pallas_kernels/axial_attention.py:
    axial_kernel_apply_headmajor`` (``_axial_kernel``): columns first, then
    rows, no norm; with its channel-interleaved wrapper ``axial_kernel_apply``.

Per (sample, head): ``out[i, l, :] = sum_m ky[l, m] sum_j kx[i, j] phi[j, m, :]``,
each apply summed in f32 and rounded to phi's dtype where the TPU kernel
rounds it. The kernels kx and ky are cast to phi's dtype, as
``fab_axial_in_fused`` casts them.

What bounds it on an H100: bytes (16 FLOP per byte at 16x16, d 64).
Design (details in the source): one block per (sample x head, tile of dt
channels) keeps the whole zero-padded H x W plane of its channels in shared
memory; in bf16 and f16 both applies run in place on tensor cores
(``mma.sync``), the norm's sums are reduced from registers in a fixed order,
and the slab moves as 16-byte copies; f32 keeps CUDA-core FMAs. The TPU
kernel's block-diagonal head packing, its slab transposes and its Mosaic
shape limit (8 | H, 8 | W, 64 | d) are gone. A shape outside the kernels'
limits raises with the text of the C side's ``lns_axial_limit``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.utils import profiling

# the C entry points' dtype argument
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PLAIN, _NORM, _STATS = 0, 1, 2  # the kernel's modes after the applies


def _axial_plain(kx, ky, phi, rows_first: bool):
    """kx [G, H, H], ky [G, W, W], phi [G, H, W, d] -> [G, H, W, d]; each
    apply sums in f32 and is rounded to phi's dtype."""
    dt = phi.dtype
    kx, ky = kx.to(dt).float(), ky.to(dt).float()

    def rows(x):
        return torch.einsum("gij,gjmd->gimd", kx, x.float()).to(dt)

    def cols(x):
        return torch.einsum("glm,gjmd->gjld", ky, x.float()).to(dt)

    return cols(rows(phi)) if rows_first else rows(cols(phi))


def _instance_norm_plain(y, eps: float):
    """InstanceNorm of y [B, n, H, W, d] over (H, W), as the TPU kernel
    computes it: f32 statistics (two-pass for f32; for bf16 / f16 the mean of
    the squares taken in y's dtype, minus the squared mean, clamped at 0),
    then ``(y - mean) * inv`` in y's dtype."""
    yf = y.float()
    mean = yf.mean(dim=(2, 3), keepdim=True)
    if y.dtype == torch.float32:
        var = (yf - mean).square().mean(dim=(2, 3), keepdim=True)
    else:
        var = (y.square().float().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    return (y - mean.to(y.dtype)) * inv.to(y.dtype)


def axial_stats_plain(y):
    """The statistics output: per (B, n, d) the f32 sums over (H, W) of y
    [B, n, H, W, d] and of the f32 square of y -> [B, n, d, 2]."""
    yf = y.float()
    return torch.stack([yf.sum(dim=(2, 3)), yf.square().sum(dim=(2, 3))], dim=-1)


def fab_axial_in_plain(kx, ky, phi, with_instance_norm: bool = True, eps: float = 1e-5,
                       stats: bool = False, heads_last: bool = False):
    """Plain PyTorch version of ``fab_axial_in_fused``."""
    if heads_last:  # [B, H, W, n, d] in and out
        res = fab_axial_in_plain(kx, ky, phi.permute(0, 3, 1, 2, 4), with_instance_norm, eps,
                                 stats)
        if stats:
            return res[0].permute(0, 2, 3, 1, 4), res[1]
        return res.permute(0, 2, 3, 1, 4)
    b, n, h, w, d = phi.shape
    y = _axial_plain(kx.reshape(b * n, h, h), ky.reshape(b * n, w, w),
                     phi.reshape(b * n, h, w, d), rows_first=True).reshape(phi.shape)
    if stats:
        return y, axial_stats_plain(y)
    return _instance_norm_plain(y, eps) if with_instance_norm else y


def axial_kernel_apply_headmajor_plain(kx, ky, phi):
    """Plain PyTorch version of ``axial_kernel_apply_headmajor``."""
    return _axial_plain(kx, ky, phi, rows_first=False)


@functools.lru_cache(maxsize=None)
def _limit(code: int, h: int, w: int, d: int):
    """The C side's statement of the kernels' limits for this shape: None
    when they take it, else the limit it breaks."""
    msg = _build.library().lns_axial_limit(code, h, w, d)
    return msg.decode() if msg else None


def axial_plan(dtype: torch.dtype, g: int, h: int, w: int, d: int, d_tile: int = 0) -> dict:
    """The kernel's launch for a shape (needs the card): channels per block
    (``d_tile``; 0 takes the kernel's rule), tiles of d, blocks, shared
    memory bytes per block and blocks resident per SM."""
    res = (ctypes.c_int * 5)()
    _build.check(_build.library().lns_axial_plan(_DTYPE_CODE[dtype], g, h, w, d, d_tile, res),
                 f"lns_axial_plan({dtype}, {h}x{w} d{d}, d_tile {d_tile})")
    return dict(zip(("d_tile", "tiles", "blocks", "smem_bytes", "blocks_per_sm"), res))


def launch(name, kx, ky, phi, dims, rows_first: bool, mode: int, eps: float,
           stats_shape=None, d_tile: int = 0, t0: int = 0):
    """One launch on phi's CUDA device: dims = (G, H, W, d, pixel stride);
    kx holds G [H, H] and ky G [W, W] matrices, phi G planes of H x W
    pixels, d channels each: head-major [G, H, W, d] (stride d) or heads
    last [B, H, W, n, d] with G = B n (stride n d). Returns out in phi's
    shape, and with mode ``_STATS`` the f32 stats [G, d, 2] in
    ``stats_shape``. ``d_tile`` 0 takes the kernel's rule; the plan probes
    pass another. Counts the launch under ``axial.<name>``, with `t0` (the
    wrapper's ``profiling.clock()``) its host time. Kept lean (no
    reshapes): at the paths' shapes the host's time per call exceeds the
    kernel's."""
    code = _DTYPE_CODE.get(phi.dtype)
    if code is None:
        raise TypeError(f"{name}: unsupported dtype {phi.dtype}")
    g, h, w, d, ps = dims
    dev = phi.device
    if kx.device != dev or ky.device != dev:
        raise ValueError(f"{name}: kx, ky must be on {dev}, got {kx.device}, {ky.device}")
    limit = _limit(code, h, w, d)
    if limit:
        raise ValueError(f"{name}: {str(phi.dtype)[6:]} at {h}x{w} d{d} needs {limit}")
    given = kx, ky, phi
    if not phi.is_contiguous() or phi.data_ptr() % 16:  # rows of 8 channels: 16-byte copies
        phi = phi.clone(memory_format=torch.contiguous_format)
    if kx.dtype != phi.dtype or not kx.is_contiguous():
        kx = kx.to(phi.dtype).contiguous()
    if ky.dtype != phi.dtype or not ky.is_contiguous():
        ky = ky.to(phi.dtype).contiguous()
    out = torch.empty_like(phi)
    stats = (torch.empty(stats_shape or (g, d, 2), device=dev, dtype=torch.float32)
             if mode == _STATS else None)
    rc = _build.library().lns_axial_apply(
        code, rows_first, mode, kx.data_ptr(), ky.data_ptr(), phi.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(), g, h, w, d, ps, d_tile, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        _build.check(rc, f"{name} (lns_axial_apply)")
    profiling.launched(f"axial.{name}", _build.copy_bytes(*zip(given, (kx, ky, phi))), t0)
    return out if stats is None else (out, stats)


class AxialInFunction(torch.autograd.Function):
    """Kernel 4 with a gradient, in the mode the d-space FAB core calls
    (``fab_dspace_core``: norm off, statistics out, heads last). The forward
    launches the kernel (the plain version for a CPU tensor) and saves kx,
    ky and phi; the backward recomputes ``fab_axial_in_plain`` in that mode
    under grad and returns its gradients, through both outputs (x, and the
    f32 statistics that ``_fold_norm`` consumes). The JAX package has no
    backward kernel to port (XLA differentiates ``_batched_core``)."""

    @staticmethod
    def forward(ctx, kx, ky, phi, eps: float):
        ctx.save_for_backward(kx, ky, phi)
        ctx.eps = eps
        return _fab_axial_in(kx, ky, phi, False, eps, True, True)

    @staticmethod
    def backward(ctx, grad_x, grad_stats):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = fab_axial_in_plain(*inputs, False, ctx.eps, True, True)
        grads = iter(torch.autograd.grad(outs, [t for t in inputs if t.requires_grad],
                                         (grad_x, grad_stats)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def fab_axial_in_fused(kx, ky, phi, with_instance_norm: bool = True, eps: float = 1e-5,
                       stats: bool = False, heads_last: bool = False):
    """Fused axial apply (+ InstanceNorm), head-major: kx [B, n, H, H],
    ky [B, n, W, W], phi [B, n, H, W, d] -> [B, n, H, W, d] in phi's dtype.
    With ``stats`` (and the norm off) it also returns the f32 statistics
    [B, n, d, 2]: per (sample, head, channel) the sums over (H, W) of the
    output and of its f32 square (``axial_stats_plain``). With
    ``heads_last`` phi and the output are [B, H, W, n, d] instead, the
    in-projection's own layout (no relayout around the kernel).

    The TPU kernel's ``group`` argument (how many heads it packs into one
    block-diagonal matrix) does not change the result and is dropped; so is
    its ``interpret`` flag. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises. With grad
    mode on and kx, ky or phi requiring grad, the d-space core's mode (norm
    off, ``stats``, ``heads_last``) goes through ``AxialInFunction``, which
    launches the same kernel and carries the plain version's gradient; the
    other modes refuse a gradient on a CUDA tensor."""
    if stats and with_instance_norm:
        raise ValueError("fab_axial_in_fused: stats are returned with the norm off")
    if (stats and heads_last and torch.is_grad_enabled()
            and any(t.requires_grad for t in (kx, ky, phi))):
        return AxialInFunction.apply(kx, ky, phi, eps)
    return _fab_axial_in(kx, ky, phi, with_instance_norm, eps, stats, heads_last)


def _fab_axial_in(kx, ky, phi, with_instance_norm: bool, eps: float, stats: bool,
                  heads_last: bool):
    """The launch (or, for a CPU tensor, the plain version)."""
    t0 = profiling.clock()
    if not _build.on_cuda(phi, "fab_axial_in_fused", kx, ky):
        return fab_axial_in_plain(kx, ky, phi, with_instance_norm, eps, stats, heads_last)
    if phi.dim() != 5:
        raise ValueError("fab_axial_in_fused: phi must be [B, n, H, W, d] or [B, H, W, n, d]")
    if heads_last:
        b, h, w, n, d = phi.shape
    else:
        b, n, h, w, d = phi.shape
    if kx.shape != (b, n, h, h) or ky.shape != (b, n, w, w):
        raise ValueError(f"fab_axial_in_fused: kx, ky must be {(b, n, h, h)}, {(b, n, w, w)}, "
                         f"got {tuple(kx.shape)}, {tuple(ky.shape)}")
    mode = _STATS if stats else _NORM if with_instance_norm else _PLAIN
    return launch("fab_axial_in_fused", kx, ky, phi,
                  (b * n, h, w, d, n * d if heads_last else d), True, mode, eps, (b, n, d, 2),
                  t0=t0)


def axial_kernel_apply_headmajor(kx, ky, phi):
    """Axial apply, columns first: kx [G, H, H], ky [G, W, W],
    phi [G, H, W, d] with G = B x heads -> [G, H, W, d] in phi's dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (kernel 4's source, columns first, no norm) or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(phi, "axial_kernel_apply_headmajor", kx, ky):
        return axial_kernel_apply_headmajor_plain(kx, ky, phi)
    if phi.dim() != 4:
        raise ValueError("axial_kernel_apply_headmajor: phi must be [G, H, W, d]")
    g, h, w, d = phi.shape
    if kx.shape != (g, h, h) or ky.shape != (g, w, w):
        raise ValueError(f"axial_kernel_apply_headmajor: kx, ky must be {(g, h, h)}, "
                         f"{(g, w, w)}, got {tuple(kx.shape)}, {tuple(ky.shape)}")
    return launch("axial_kernel_apply_headmajor", kx, ky, phi, (g, h, w, d, d), False, _PLAIN,
                  0.0, t0=t0)


def axial_kernel_apply(kx, ky, phi, heads: int):
    """Channel-interleaved wrapper: kx [B, heads, H, H], ky [B, heads, W, W],
    phi [B, H, W, heads * d] in (head, d) channel order -> the same shape.
    One relayout each way around ``axial_kernel_apply_headmajor``."""
    b, h, w, c = phi.shape
    d = c // heads
    phi_g = phi.reshape(b, h, w, heads, d).permute(0, 3, 1, 2, 4).reshape(b * heads, h, w, d)
    out = axial_kernel_apply_headmajor(kx.reshape(b * heads, h, h),
                                       ky.reshape(b * heads, w, w), phi_g)
    return out.reshape(b, heads, h, w, d).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
