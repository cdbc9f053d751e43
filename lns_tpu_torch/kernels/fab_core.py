"""FAB core: the factorized-attention block's axial applications, InstanceNorm
statistics and folded out-projection, as a CUDA C++ kernel for Hopper
(``csrc/fab_core.cu``).

Replaces ``lns_tpu/pallas_kernels/fab_core.py: fab_fused_core``
(``_fused_kernel``), the drop-in for ``FABlock2D._batched_gram_core``
(``lns_tpu/ops/factorized_attention.py:353``). Per (sample, head n):

    bb_n   = k_x[n] . u . k_y[n]^T        (channel space; in_proj commutes)
    phi_n  = bb_n . W_in[:, n]            (never formed: its InstanceNorm
                                           moments come from sum(k_x), sum(k_y)
                                           and the c x c Gram of bb_n)
    m_n    = W_in[:, n] diag(inv_n) W_o1[n],   bias_n = (mean_n inv_n) W_o1[n]
    out    = sum_n (bb_n . m_n - bias_n)

What bounds it on an H100: arithmetic, not bytes. Per NS2d decode chunk
(116 frames, 8 heads, c = 64) the 32x32 block is ~31 GFLOP against ~34 MB
of u, k and out, above the card's bf16 ridge, so the kernel's products run
on tensor cores in bf16.

Design. The TPU kernel holds a sample's whole field per program and sums the
heads over a sequential grid axis; on Hopper a sample's bb does not fit in a
block's shared memory, so the kernel runs two passes and bb never reaches
device memory:
  1. statistics, one block per (head, sample): bb tile by tile, its Gram
     summed across tiles, then m_n (in u's dtype) and bias_n (f32) to a
     small scratch [b, n, c, o] / [b, n, o];
  2. apply, one block per (tile of 8 columns, sample): recompute the tile's
     bb for each head and add bb . m_n; write the output once.
bf16 (``mma.sync`` m16n8k16, f32 accumulators, 512 threads per block): in
``_batched_gram_core``'s order, k_y first for w <= h and k_x first for
w > h (the kernels then walk the transposed field through transposed
strides of u and out), with a, bb, m, the bias, the head sum and the output
rounded to bf16 where it rounds them. u is resident in shared memory where
it fits (32x32 and 16x16 at c64), else it streams from L2 through a 2-stage
``cp.async`` ring. Shared memory per block: 225,152 bytes at 32x32 c64,
75,392 at 16x16 c64, 231,872 at 48x96 c64. The wrapper raises for a bf16
shape outside the kernel's limits, with the text of the C side's
``lns_fab_core_bf16_limit``: c a multiple of 16 up to 128, o a multiple of
16, h and w up to 128, and the block within the H100's 227 KB of shared
memory. f32: the same passes as f32 FMAs on CUDA cores, k_x first.
"""

from __future__ import annotations

import ctypes

import torch

from lns_tpu_torch.kernels import _build


def fab_core_plain(u, k_x, k_y, w_in, w_o1, eps: float = 1e-5):
    """Plain PyTorch version (``_batched_gram_core``): u [b, h, w, c],
    k_x [b, n, h, h], k_y [b, n, w, w], w_in [c, n, d], w_o1 [n, d, o] ->
    [b, h, w, o] in u's dtype, rounding a, bb, m, the bias and the output to
    it where ``_batched_gram_core`` does."""
    dt = u.dtype
    k_x, k_y, w_in = k_x.to(dt), k_y.to(dt), w_in.to(dt)
    b, h, w, c = u.shape
    n_px = h * w
    if w > h:
        a = torch.einsum("bnih,bhwc->bnwic", k_x, u)
        bb = torch.einsum("bnlw,bnwic->bnlic", k_y, a)    # (w-index, h-index)
    else:
        a = torch.einsum("bnlw,bhwc->bnhlc", k_y, u)
        bb = torch.einsum("bnih,bnhlc->bnilc", k_x, a)    # (h-index, w-index)
    kx_s = k_x.float().sum(dim=2)                         # [b, n, h]
    ky_s = k_y.float().sum(dim=2)                         # [b, n, w]
    mean_c = torch.einsum("bnh,bnw,bhwc->bnc", kx_s, ky_s, u.float()) / n_px
    bbf = bb.float()
    g = torch.einsum("bnilc,bnile->bnce", bbf, bbf)
    wf = w_in.float()
    mean = torch.einsum("bnc,cnd->bnd", mean_c, wf)
    ex2 = torch.einsum("cnd,bnce,end->bnd", wf, g / n_px, wf)
    inv = torch.rsqrt((ex2 - mean.square()).clamp_min(0.0) + eps)
    w1f = w_o1.float()
    m = torch.einsum("cnd,bnd,ndo->bnco", wf, inv, w1f).to(dt)
    bias = torch.einsum("bnd,ndo->bo", mean * inv, w1f).to(dt)[:, None, None, :]
    if w > h:
        return (torch.einsum("bnlic,bnco->blio", bb, m) - bias).transpose(1, 2).contiguous()
    return torch.einsum("bnilc,bnco->bilo", bb, m) - bias


class FabCoreFunction(torch.autograd.Function):
    """Kernel 2 with a gradient. The forward launches the kernel (the plain
    version for a CPU tensor) and saves its five inputs as they were given,
    before the wrapper's casts: w_in and w_o1 are views of the 1x1 conv
    weights, so autograd maps their gradients back to ``in_proj`` and
    ``to_out[1]``. The backward recomputes ``fab_core_plain`` from them
    under grad (the casts happen inside it) and returns that function's
    gradients. The JAX package has no backward kernel to port (XLA
    differentiates ``_batched_gram_core``), so none is written here."""

    @staticmethod
    def forward(ctx, u, k_x, k_y, w_in, w_o1, eps: float):
        ctx.save_for_backward(u, k_x, k_y, w_in, w_o1)
        ctx.eps = eps
        return _fab_core(u, k_x, k_y, w_in, w_o1, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = fab_core_plain(*inputs, ctx.eps)
        grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], grad))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def fab_fused_core(u, k_x, k_y, w_in, w_o1, eps: float = 1e-5):
    """FAB core with the JAX kernel's shapes: u [b, h, w, c] (post-GN),
    k_x [b, n, h, h], k_y [b, n, w, w], w_in [c, n, d], w_o1 [n, d, o] ->
    [b, h, w, o] in u's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises. With grad mode on and any of the five
    tensors requiring grad the call goes through ``FabCoreFunction``, which
    launches the same kernel and carries the plain version's gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, k_x, k_y, w_in, w_o1)):
        return FabCoreFunction.apply(u, k_x, k_y, w_in, w_o1, eps)
    return _fab_core(u, k_x, k_y, w_in, w_o1, eps)


def _fab_core(u, k_x, k_y, w_in, w_o1, eps: float):
    """The launch (or, for a CPU tensor, the plain version), without grad."""
    if not _build.on_cuda(u, "fab_fused_core", k_x, k_y, w_in, w_o1):
        return fab_core_plain(u, k_x, k_y, w_in, w_o1, eps)
    if u.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"fab_fused_core: unsupported dtype {u.dtype}")
    if u.dim() != 4 or not u.is_contiguous():
        raise ValueError("fab_fused_core: u must be contiguous [b, h, w, c]")
    b, h, w, c = u.shape
    n, d, o = w_o1.shape
    expect = {"k_x": (k_x, (b, n, h, h)), "k_y": (k_y, (b, n, w, w)),
              "w_in": (w_in, (c, n, d)), "w_o1": (w_o1, (n, d, o))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != u.device:
            raise ValueError(f"fab_fused_core: {name} must be {shape} on {u.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if not 0 < b <= 65535:
        raise ValueError(f"fab_fused_core: batch {b}; the grid takes 1 to 65535")
    lib = _build.library()
    if u.dtype == torch.bfloat16:
        limit = lib.lns_fab_core_bf16_limit(h, w, c, d, o)  # the kernel's own limits
        if limit:
            raise ValueError(f"fab_fused_core: bf16 at {h}x{w} c{c} d{d} o{o} needs "
                             f"{limit.decode()}")
        if u.data_ptr() % 16:  # u's rows stream as 16-byte copies
            u = u.clone()
    kx = k_x.to(u.dtype).contiguous()
    ky = k_y.to(u.dtype).contiguous()
    wi = w_in.to(u.dtype).contiguous()
    w1 = w_o1.float().contiguous()
    if w1.data_ptr() % 16:  # read as 16-byte vectors
        w1 = w1.clone()
    m = torch.empty((b, n, c, o), device=u.device, dtype=u.dtype)  # m_n, rounded to u's dtype
    bias = torch.empty((b, n, o), device=u.device, dtype=torch.float32)
    out = torch.empty((b, h, w, o), device=u.device, dtype=u.dtype)
    rc = lib.lns_fab_core(
        _build.DTYPE_CODE[u.dtype], u.data_ptr(), kx.data_ptr(), ky.data_ptr(),
        wi.data_ptr(), w1.data_ptr(), m.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n, h, w, c, d, o, ctypes.c_float(eps),
        torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(rc, "lns_fab_core")
    fab_fused_core.launches += 1
    return out


fab_fused_core.launches = 0
