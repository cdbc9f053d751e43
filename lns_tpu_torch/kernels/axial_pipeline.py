"""The axial apply as a pipeline of two kernels, CUDA C++ for Hopper
(``csrc/axial_pipeline.cu``).

Replaces ``lns_tpu/pallas_kernels/axial_pipeline.py``:

  * ``bmm_blockdiag`` (``_bmm_kernel``): batched ``[B, G, M, M] @ [B, G, M, N]``
    with f32 sums, rounded to x's dtype. ``kb`` may be any matrix: the
    block-diagonal structure of the pipeline's operand is not used. Bound
    by bytes on an H100 (64 FLOP per byte at M = 128, bf16). In bf16 it runs
    on tensor cores (``mma.sync``, f32 accumulators): 128 x 128 output tiles,
    K streamed through a 3-stage ``cp.async`` ring, 16-byte stores; 56,832
    bytes of shared memory per block. Any M and N: ragged tiles are
    zero-filled, and M or N not a multiple of 8 takes element-wise copies.
    In f32 it is an SGEMM on CUDA cores (the TPU kernel's f32 dot runs at
    HIGHEST precision, which has no bf16 tensor-core form).
  * ``transpose_hw`` (``_transpose_kernel``): ``[B, N, H, W, D] ->
    [B, N, W, H, D]``, one read and one write. It is a single pass of data
    movement; it is written in CUDA C++ beside ``bmm_blockdiag`` rather
    than in Triton, so the pipeline is one source.

``axial_apply_pipeline`` composes them as the JAX package does: row apply,
h <-> w swap, column apply, swap back. ``blockdiag_embed`` builds the
block-diagonal operand in plain torch, as the JAX package builds it in XLA.
Neither kernel is on a model's path; they are library kernels, as on the TPU.
"""

from __future__ import annotations

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.utils import profiling


def blockdiag_embed(k, group: int):
    """[B, heads, n, n] -> [B, heads // group, group * n, group * n], the
    heads of each group on the diagonal."""
    b, heads, n, _ = k.shape
    k5 = k.reshape(b, heads // group, group, n, n)
    eye = torch.eye(group, dtype=k.dtype, device=k.device)
    out = torch.einsum("bgpij,pq->bgpiqj", k5, eye)
    return out.reshape(b, heads // group, group * n, group * n)


def bmm_blockdiag_plain(kb, x):
    """Plain PyTorch version of ``bmm_blockdiag``."""
    return torch.matmul(kb.to(x.dtype).float(), x.float()).to(x.dtype)


def bmm_blockdiag(kb, x):
    """kb [B, G, M, M] @ x [B, G, M, N] -> [B, G, M, N] in x's dtype (kb is
    cast to it). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(x, "bmm_blockdiag", kb):
        return bmm_blockdiag_plain(kb, x)
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"bmm_blockdiag: unsupported dtype {x.dtype}")
    if x.dim() != 4:
        raise ValueError("bmm_blockdiag: x must be [B, G, M, N]")
    b, g, m, n = x.shape
    if tuple(kb.shape) != (b, g, m, m) or kb.device != x.device:
        raise ValueError(f"bmm_blockdiag: kb must be {(b, g, m, m)} on {x.device}, "
                         f"got {tuple(kb.shape)} on {kb.device}")
    if not 0 < b * g <= 65535:
        raise ValueError(f"bmm_blockdiag: {b * g} products; the grid takes 1 to 65535")
    given = kb, x
    x = x.contiguous()
    kb = kb.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    rc = _build.library().lns_bmm(_build.DTYPE_CODE[x.dtype], kb.data_ptr(), x.data_ptr(),
                                  out.data_ptr(), b * g, m, n,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bmm_blockdiag (lns_bmm)")
    profiling.launched("axial_pipeline.bmm_blockdiag", _build.copy_bytes(*zip(given, (kb, x))), t0)
    return out


def transpose_hw_plain(x):
    """Plain PyTorch version of ``transpose_hw``."""
    return x.transpose(2, 3).contiguous()


def transpose_hw(x):
    """[B, N, H, W, D] -> [B, N, W, H, D], any dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on the current
    stream or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(x, "transpose_hw"):
        return transpose_hw_plain(x)
    if x.dim() != 5:
        raise ValueError("transpose_hw: x must be [B, N, H, W, D]")
    b, n, h, w, d = x.shape
    if b * n * h * w >= 2**31:
        raise ValueError("transpose_hw: more than 2**31 rows")
    given, x = x, x.contiguous()
    out = torch.empty((b, n, w, h, d), dtype=x.dtype, device=x.device)
    row = d * x.element_size()
    vec = next(v for v in (16, 8, 4, 2, 1)
               if row % v == 0 and x.data_ptr() % v == 0 and out.data_ptr() % v == 0)
    rc = _build.library().lns_transpose_hw(vec, x.data_ptr(), out.data_ptr(), b * n, h, w, row,
                                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "transpose_hw (lns_transpose_hw)")
    profiling.launched("axial_pipeline.transpose_hw", _build.copy_bytes((given, x)), t0)
    return out


def axial_apply_pipeline(kx, ky, phi, group=None, final_transpose: bool = True):
    """Axial apply, head-major, as row bmm -> swap -> column bmm (-> swap):
    kx [B, heads, H, H], ky [B, heads, W, W], phi [B, heads, H, W, d] ->
    [B, heads, H, W, d], or the w-major [B, heads, W, H, d] when
    ``final_transpose`` is False. ``group`` heads share one block-diagonal
    operand (default: the most heads with group x min(H, W) <= 128)."""
    b, heads, h, w, d = phi.shape
    if group is None:
        group = 1
        for g in (1, 2, 4, 8):
            if heads % g == 0 and g * min(h, w) <= 128:
                group = g
    gg = heads // group
    kxb = blockdiag_embed(kx.to(phi.dtype), group)
    kyb = blockdiag_embed(ky.to(phi.dtype), group)
    x = bmm_blockdiag(kxb, phi.reshape(b, gg, group * h, w * d))
    x = transpose_hw(x.reshape(b, heads, h, w, d))
    x = bmm_blockdiag(kyb, x.reshape(b, gg, group * w, h * d)).reshape(b, heads, w, h, d)
    return transpose_hw(x) if final_transpose else x
