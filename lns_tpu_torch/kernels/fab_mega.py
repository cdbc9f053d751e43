"""The FAB core's two passes that recompute the apply pair instead of storing
it, and their interior dot: CUDA C++ for Hopper (``csrc/fab_mega.cu``).

Replaces ``benchmarks/probe_fab_mega.py``:

  * ``fab_mega_stats`` (``stats_pass``, ``_stats_kernel``): per sample and
    head, ``a = bf16(ky . u_t)`` (contracting w), ``bb = kx . a`` in f32
    (contracting h), ``b2 = bf16(bb)`` as [(i l), c], then the Gram matrix
    ``G = b2^T b2`` and the column sums of b2, both f32;
  * ``fab_mega_apply`` (``apply_pass``, ``_apply_kernel``): the same b2, then
    ``b2 . m[b, n]`` in f32 summed over the heads in f32, minus ``bias[b]``,
    rounded once. The bias is [B, C], as the probe's ``main()`` and
    ``xla_full`` mean it (its Pallas kernel's block spec takes [B, 1, C]);
  * ``interior_dot`` (the pieces A and B2 of ``run_pieces``):
    ``kx [i, h] . a [l, h, c] -> [i, l, c]``, f32 sums, rounded once: one
    orientation of ``mosaic_dots.dot_general`` (``csrc/mosaic_dots.cu``),
    contracting ``((1,), (1,))``, which it launches.

The kernels take the probe's shape, h = w = 32 and c = 64 in bf16 (stated
once, in C: ``lns_fab_mega_limit``, ``lns_interior_dot_limit``); the plain
versions take any. Bound by operations on an H100: 16.8 MFLOP per sample
and head. Both passes run a block per sample on ``wgmma`` with u read once
into shared memory and the head-major values never in device memory: the
statistics pass walks the heads; the apply pass walks tiles of 16 columns
l, and in each the heads, keeping the tile's head sum in registers (b2
from step 2's accumulators is the A operand of b2 . m; kx, ky's rows and
m of the next iteration come by TMA). The interior dot runs on
``mma.sync`` in ``dot_general``. None is on a model's path: kernel 2
(``fab_core.fab_fused_core``) is the FAB core the models run; these passes
measure the design that recomputes bb in place of kernel 2's bb scratch.
"""

from __future__ import annotations

import torch

from lns_tpu_torch.kernels import _build, mosaic_dots
from lns_tpu_torch.utils import profiling


def _b2(u_t, kx, ky):
    """The rounded apply pair as [b, n, (i l), c] f32 values."""
    dt = u_t.dtype
    a = torch.einsum("bnlw,bwhc->bnlhc", ky.to(dt).float(), u_t.float()).to(dt)
    bb = torch.einsum("bnih,bnlhc->bnilc", kx.to(dt).float(), a.float())
    b, n, i, l, c = bb.shape
    return bb.to(dt).float().reshape(b, n, i * l, c)


def fab_mega_stats_plain(u_t, kx, ky):
    """Plain PyTorch version of ``fab_mega_stats``."""
    b2 = _b2(u_t, kx, ky)
    return b2.transpose(-1, -2) @ b2, b2.sum(-2)


def fab_mega_apply_plain(u_t, kx, ky, m, bias):
    """Plain PyTorch version of ``fab_mega_apply``."""
    t = _b2(u_t, kx, ky) @ m.to(u_t.dtype).float()
    return (t.sum(1) - bias.to(u_t.dtype).float()[:, None, :]).to(u_t.dtype)


def interior_dot_plain(kx, a):
    """Plain PyTorch version of ``interior_dot``: ``dot_general``'s, in its
    orientation."""
    return mosaic_dots.dot_general_plain(kx.to(a.dtype), a, ((1,), (1,)), out_dtype=a.dtype)


def _limit(fn, name, dtype, *dims):
    msg = fn(_build.DTYPE_CODE.get(dtype, -1), *dims)
    if msg:
        raise ValueError(f"{name}: {str(dtype)[6:]} at {list(dims)} needs {msg.decode()}")


def fab_mega_stats(u_t, kx, ky):
    """u_t [b, w, h, c] (u with h and w swapped), kx [b, n, h, h],
    ky [b, n, w, w] -> (G [b, n, c, c], s [b, n, c]), both f32: a block per
    sample on ``wgmma``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(u_t, "fab_mega_stats", kx, ky):
        return fab_mega_stats_plain(u_t, kx, ky)
    if u_t.dim() != 4 or kx.dim() != 4:
        raise ValueError("fab_mega_stats: u_t must be [b, w, h, c] and kx [b, n, h, h]")
    b, w, h, c = u_t.shape
    n = kx.shape[1]
    _build.check_shapes("fab_mega_stats", u_t.device, {"kx": (kx, (b, n, h, h)),
                                                       "ky": (ky, (b, n, w, w))})
    lib = _build.library()
    _limit(lib.lns_fab_mega_limit, "fab_mega_stats", u_t.dtype, b, h, w, c)
    given = u_t, kx, ky
    u_t, kx, ky = (_build.ready(t, u_t.dtype) for t in given)
    g = torch.empty((b, n, c, c), device=u_t.device, dtype=torch.float32)
    s = torch.empty((b, n, c), device=u_t.device, dtype=torch.float32)
    rc = lib.lns_fab_mega_stats(u_t.data_ptr(), kx.data_ptr(), ky.data_ptr(), g.data_ptr(),
                                s.data_ptr(), b, n,
                                torch.cuda.current_stream(u_t.device).cuda_stream)
    _build.check(rc, "fab_mega_stats (lns_fab_mega_stats)")
    profiling.launched("fab_mega.fab_mega_stats", _build.copy_bytes(*zip(given, (u_t, kx, ky))),
                       t0)
    return g, s


def fab_mega_apply(u_t, kx, ky, m, bias):
    """u_t [b, w, h, c], kx [b, n, h, h], ky [b, n, w, w], m [b, n, c, c],
    bias [b, c] -> [b, h * w, c] in u_t's dtype, rows (i, l): a block per
    sample on ``wgmma``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(u_t, "fab_mega_apply", kx, ky, m, bias):
        return fab_mega_apply_plain(u_t, kx, ky, m, bias)
    if u_t.dim() != 4 or kx.dim() != 4:
        raise ValueError("fab_mega_apply: u_t must be [b, w, h, c] and kx [b, n, h, h]")
    b, w, h, c = u_t.shape
    n = kx.shape[1]
    _build.check_shapes("fab_mega_apply", u_t.device, {
        "kx": (kx, (b, n, h, h)), "ky": (ky, (b, n, w, w)), "m": (m, (b, n, c, c)),
        "bias": (bias, (b, c))})
    lib = _build.library()
    _limit(lib.lns_fab_mega_limit, "fab_mega_apply", u_t.dtype, b, h, w, c)
    given = u_t, kx, ky, m, bias
    u_t, kx, ky, m, bias = (_build.ready(t, u_t.dtype) for t in given)
    out = torch.empty((b, h * w, c), device=u_t.device, dtype=u_t.dtype)
    rc = lib.lns_fab_mega_apply(u_t.data_ptr(), kx.data_ptr(), ky.data_ptr(), m.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), b, n,
                                torch.cuda.current_stream(u_t.device).cuda_stream)
    _build.check(rc, "fab_mega_apply (lns_fab_mega_apply)")
    profiling.launched("fab_mega.fab_mega_apply",
                       _build.copy_bytes(*zip(given, (u_t, kx, ky, m, bias))), t0)
    return out


def interior_dot(kx, a):
    """kx [i, k] . a [l, k, c] -> [i, l, c] in a's dtype (kx cast to it), JAX's
    order: ``dot_general``'s straight x transposed orientation, which a CUDA
    tensor launches on the current stream (or raises); a CPU tensor takes
    the plain version. Its launch is counted twice: as its own and as
    ``dot_general``'s."""
    t0 = profiling.clock()
    if not _build.on_cuda(a, "interior_dot", kx):
        return interior_dot_plain(kx, a)
    if kx.dim() != 2 or a.dim() != 3:
        raise ValueError("interior_dot: kx must be [i, k] and a [l, k, c]")
    l_dim, k, c = a.shape
    i = kx.shape[0]
    _build.check_shapes("interior_dot", a.device, {"kx": (kx, (i, k))})
    _limit(_build.library().lns_interior_dot_limit, "interior_dot", a.dtype, l_dim, i, k, c)
    kc = kx.to(a.dtype)
    out = mosaic_dots.dot_general(kc, a, ((1,), (1,)), out_dtype=a.dtype)
    profiling.launched("fab_mega.interior_dot", _build.copy_bytes((kx, kc)), t0)
    return out
