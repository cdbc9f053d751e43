"""Head-major axial apply, with an optional InstanceNorm, as a CUDA C++
kernel for Hopper (``csrc/axial.cu``).

Replaces two TPU kernels with one source:

  * ``lns_tpu/pallas_kernels/axial_fused.py: fab_axial_in_fused``
    (``_fab_kernel``): rows first, then columns, then InstanceNorm over
    (H, W) per (sample, head, d). It carries the FAB block's d-space core
    (``FABlock2D._batched_core``, ``lns_tpu/ops/factorized_attention.py``).
  * ``lns_tpu/pallas_kernels/axial_attention.py:
    axial_kernel_apply_headmajor`` (``_axial_kernel``): columns first, then
    rows, no norm; with its channel-interleaved wrapper ``axial_kernel_apply``.

Per (sample, head): ``out[i, l, :] = sum_m ky[l, m] sum_j kx[i, j] phi[j, m, :]``,
each apply rounded to phi's dtype where the TPU kernel rounds it. The kernels
kx and ky are cast to phi's dtype, as ``fab_axial_in_fused`` casts them.

Design (details in the source): one block per (sample x head, tile of dt
channels) keeps the whole H x W plane of its channels in shared memory, so
both applies and the norm's statistics stay inside the block. The TPU
kernel's block-diagonal head packing, its slab transposes and its Mosaic
shape limit (8 | H, 8 | W, 64 | d) are gone: any H, W and d are taken.
"""

from __future__ import annotations

import ctypes

import torch

from lns_tpu_torch.kernels import _build

_THREADS = 256  # kThreads in csrc/axial.cu
_SMEM_MAX = 232448  # dynamic shared memory one block may use on sm_90


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
    computes it: f32 statistics (two-pass for f32; for bf16 the mean of the
    squares taken in bf16, minus the squared mean, clamped at 0), then
    ``(y - mean) * inv`` in y's dtype."""
    yf = y.float()
    mean = yf.mean(dim=(2, 3), keepdim=True)
    if y.dtype == torch.float32:
        var = (yf - mean).square().mean(dim=(2, 3), keepdim=True)
    else:
        var = (y.square().float().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    return (y - mean.to(y.dtype)) * inv.to(y.dtype)


def fab_axial_in_plain(kx, ky, phi, with_instance_norm: bool = True, eps: float = 1e-5):
    """Plain PyTorch version of ``fab_axial_in_fused``."""
    b, n, h, w, d = phi.shape
    y = _axial_plain(kx.reshape(b * n, h, h), ky.reshape(b * n, w, w),
                     phi.reshape(b * n, h, w, d), rows_first=True).reshape(phi.shape)
    return _instance_norm_plain(y, eps) if with_instance_norm else y


def axial_kernel_apply_headmajor_plain(kx, ky, phi):
    """Plain PyTorch version of ``axial_kernel_apply_headmajor``."""
    return _axial_plain(kx, ky, phi, rows_first=False)


def _d_tile(h: int, w: int, d: int, itemsize: int) -> int:
    """The largest divisor dt of d (at most one per thread) whose block fits
    in half the shared memory (two blocks per SM), else in all of it."""
    fixed = 4 * (h * h + w * w + 2 * _THREADS)
    for budget in (_SMEM_MAX // 2, _SMEM_MAX):
        for dt in range(min(d, _THREADS), 0, -1):
            if d % dt == 0 and fixed + dt * (8 + 2 * h * w * itemsize) <= budget:
                return dt
    raise ValueError(f"axial kernel: an {h}x{w} plane does not fit in shared memory")


def _launch(name, kx, ky, phi, rows_first: bool, with_in: bool, eps: float):
    """kx [G, H, H], ky [G, W, W], phi [G, H, W, d] on one CUDA device."""
    if phi.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {phi.dtype}")
    g, h, w, d = phi.shape
    for what, t, shape in (("kx", kx, (g, h, h)), ("ky", ky, (g, w, w))):
        if tuple(t.shape) != shape or t.device != phi.device:
            raise ValueError(f"{name}: {what} must be {shape} on {phi.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if not 0 < g <= 65535:
        raise ValueError(f"{name}: {g} (sample, head) pairs; the grid takes 1 to 65535")
    phi = phi.contiguous()
    kx = kx.to(phi.dtype).contiguous()
    ky = ky.to(phi.dtype).contiguous()
    out = torch.empty_like(phi)
    dt = _d_tile(h, w, d, phi.element_size())
    rc = _build.library().lns_axial_apply(
        _build.DTYPE_CODE[phi.dtype], int(rows_first), int(with_in), kx.data_ptr(),
        ky.data_ptr(), phi.data_ptr(), out.data_ptr(), g, h, w, d, dt, ctypes.c_float(eps),
        torch.cuda.current_stream(phi.device).cuda_stream)
    _build.check(rc, f"{name} (lns_axial_apply)")
    return out


def fab_axial_in_fused(kx, ky, phi, with_instance_norm: bool = True, eps: float = 1e-5):
    """Fused axial apply (+ InstanceNorm), head-major: kx [B, n, H, H],
    ky [B, n, W, W], phi [B, n, H, W, d] -> [B, n, H, W, d] in phi's dtype.

    The TPU kernel's ``group`` argument (how many heads it packs into one
    block-diagonal matrix) does not change the result and is dropped; so is
    its ``interpret`` flag. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises."""
    if not _build.on_cuda(phi, "fab_axial_in_fused"):
        return fab_axial_in_plain(kx, ky, phi, with_instance_norm, eps)
    if phi.dim() != 5:
        raise ValueError("fab_axial_in_fused: phi must be [B, n, H, W, d]")
    b, n, h, w, d = phi.shape
    if kx.shape != (b, n, h, h) or ky.shape != (b, n, w, w):
        raise ValueError(f"fab_axial_in_fused: kx, ky must be {(b, n, h, h)}, {(b, n, w, w)}, "
                         f"got {tuple(kx.shape)}, {tuple(ky.shape)}")
    out = _launch("fab_axial_in_fused", kx.reshape(b * n, h, h), ky.reshape(b * n, w, w),
                  phi.reshape(b * n, h, w, d), True, with_instance_norm, eps)
    fab_axial_in_fused.launches += 1
    return out.reshape(phi.shape)


fab_axial_in_fused.launches = 0


def axial_kernel_apply_headmajor(kx, ky, phi):
    """Axial apply, columns first: kx [G, H, H], ky [G, W, W],
    phi [G, H, W, d] with G = B x heads -> [G, H, W, d] in phi's dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (kernel 4's, with the norm off) or raises."""
    if not _build.on_cuda(phi, "axial_kernel_apply_headmajor"):
        return axial_kernel_apply_headmajor_plain(kx, ky, phi)
    if phi.dim() != 4:
        raise ValueError("axial_kernel_apply_headmajor: phi must be [G, H, W, d]")
    out = _launch("axial_kernel_apply_headmajor", kx, ky, phi, False, False, 0.0)
    axial_kernel_apply_headmajor.launches += 1
    return out


axial_kernel_apply_headmajor.launches = 0


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
