"""FAB core: the factorized-attention block's axial applications, InstanceNorm
statistics and folded out-projection, as CUDA C++ kernels for Hopper
(``csrc/fab_core.cu``, with the Hopper helpers of ``csrc/hopper.cuh``).

Replaces ``lns_tpu/pallas_kernels/fab_core.py: fab_fused_core``
(``_fused_kernel``), the drop-in for ``FABlock2D._batched_gram_core``
(``lns_tpu/ops/factorized_attention.py:353``). Per (sample, head n):

    bb_n   = k_x[n] . u . k_y[n]^T        (channel space; in_proj commutes)
    phi_n  = bb_n . W_in[:, n]            (never formed: its InstanceNorm
                                           moments come from sum(k_x), sum(k_y)
                                           and the c x c Gram of bb_n)
    m_n    = W_in[:, n] diag(inv_n) W_o1[n],   bias_n = (mean_n inv_n) W_o1[n]
    out    = sum_n (bb_n . m_n - bias_n)

What bounds it on an H100: arithmetic at the card's bf16 tensor-core rate.
One call at SW's 48x96, c = o = d = 64, 8 heads, b336 is ~437 GFLOP (0.442
ms at 989 TFLOP/s) against ~0.66 GB of u, x, k and out (0.20 ms at 3.35
TB/s); NS2d's 32x32 b116 is ~24.5 GFLOP (0.025 ms) against ~0.05 GB. The
design below adds its bb scratch's write and read: 3.2 GB (0.95 ms) at SW's
48x96, 0.24 GB (0.07 ms) at 32x32 b116.

Design (bf16). The TPU kernel holds a sample's whole field per program and
sums the heads over a sequential grid axis; on Hopper a sample's bb does not
fit in a block, so the core runs four passes:
  1. mean: one block per sample reads its x (or u) once for all heads and
     forms mean_c [b, n, c] (``block_mean_c``, or ``rounded_mean_c``);
  2. statistics: one block per (head, sample), the sample's heads in one
     thread-block cluster (8 at every path shape). Its rows of u stream
     through a ring of shared memory by TMA, each stage loaded once and
     multicast to every block of the cluster, so u is read from device
     memory once per sample (per tile of L columns of the first-applied
     axis: once at NS2d's fields, 6 times at SW's 48x96). A producer
     warpgroup issues the copies; two consumer warpgroups run both axial
     applies and the Gram on ``wgmma`` from shared memory (a = bf16(u .
     k_y^T) a ring stage of rows at a time, bb = bf16(k_x . a) column by
     column over a, G += bb^T bb), write bb to a device scratch [b, n, h,
     w, cp] once (TMA store) and G to a scratch [b, n, c, c];
  3. moments: one block per (head, sample) forms E[phi^2], the mean, m_n
     (bf16) and bias_n (f32) from G on CUDA cores, several blocks to an SM;
  4. output: one block per (128 pixels, 64 columns of o, sample) runs
     sum_n bb_n . m_n as one ``wgmma`` product with K = n cp in f32 (a head
     per ring stage), subtracts the heads' bias summed in order, and writes
     the tile once. No atomics: two runs give the same bits.
The axial applies run once (bb is stored, not recomputed); bb is a bf16
rounding point of ``_batched_gram_core``, so storing it changes no value.
It applies k_y first for w <= h and k_x first for w > h (the kernels then
walk the transposed field through their tensor maps' boxes, no copy), and
rounds a, bb, m, the bias, the head sum and the output to bf16 where that
function rounds them. The wrapper allocates the scratch (c padded to cp, a
multiple of 64, in bb and m) and pads the rows of k_x, k_y to a multiple of
8 elements (TMA's 16-byte strides). It raises for a bf16 shape outside the kernels' limits, with the
text of the C side's ``lns_fab_core_bf16_limit``: c a multiple of 16 up to
128, o a multiple of 16, h and w up to 128, and each pass's block within
the H100's 227 KB of shared memory. f32: two passes of f32 FMAs on CUDA
cores, k_x first (the check path, not timed).
"""

from __future__ import annotations

import ctypes
import math

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.utils import profiling


def scratch_shapes(b: int, n: int, h: int, w: int, c: int, o: int, dtype: torch.dtype) -> dict:
    """The buffers the launch allocates besides its output, {name: (shape,
    dtype)}: m_n (c padded to cp, whole 64-channel atoms, in bf16) and
    bias_n; in bf16 also the bb scratch (c padded), the mean's mean_c and
    the Gram."""
    f32 = torch.float32
    if dtype != torch.bfloat16:
        return {"m": ((b, n, c, o), dtype), "bias": ((b, n, o), f32)}
    cp = -(-c // 64) * 64
    return {"m": ((b, n, cp, o), dtype), "bias": ((b, n, o), f32),
            "bb": ((b, n, h, w, cp), dtype), "mean": ((b, n, c), f32),
            "gram": ((b, n, c, c), f32)}


def scratch_bytes(b: int, n: int, h: int, w: int, c: int, o: int, dtype: torch.dtype) -> dict:
    """The bytes of each buffer of ``scratch_shapes``."""
    return {k: math.prod(shape) * dt.itemsize
            for k, (shape, dt) in scratch_shapes(b, n, h, w, c, o, dtype).items()}


def rounded_mean_c(u, k_x, k_y):
    """``_batched_gram_core``'s own mean_c [b, n, c] f32, the pixel mean of
    the bb it forms: the row sums of the kernels in u's dtype, their outer
    product, times u (what the function computes jitted alone)."""
    dt, (h, w) = u.dtype, u.shape[1:3]
    kx_s, ky_s = k_x.to(dt).float().sum(dim=2), k_y.to(dt).float().sum(dim=2)
    return torch.einsum("bnh,bnw,bhwc->bnc", kx_s, ky_s, u.float()) / (h * w)


def block_mean_c(u, mean_from):
    """mean_c [b, n, c] f32 as the jitted JAX FAB block reads it into
    ``_batched_gram_core`` (bf16; ``ops/factorized_attention.py`` names the
    fusions): from the GroupNorm(1) output before its last rounding, T(x sc)
    + sh in f32, and the row sums of the kernels' f32 products before
    theirs. mean_from = (x [b, h, w, c] the block's input in u's dtype,
    coef [b, 2, c] the GroupNorm's rounded sc and sh as f32, kx_s [b, n, h]
    and ky_s [b, n, w] f32), with u = T(T(x sc) + sh). The gradient goes
    through u, kx_s and ky_s: the rounding residue T(x sc) + sh - u has none
    (rounding passes the gradient on unchanged)."""
    x, coef, kx_s, ky_s = mean_from
    h, w = u.shape[1:3]
    uf = (x * coef[:, None, None, 0].to(x.dtype)).float() + coef[:, None, None, 1]
    u32 = u.float()
    u32 = u32 + (uf - u32).detach()  # uf's value, u's gradient
    return torch.einsum("bnh,bnw,bhwc->bnc", kx_s, ky_s, u32) / (h * w)


def _apply_pair(u, k_x, k_y):
    """bb, both axial applies in ``_batched_gram_core``'s order and
    rounding: (b, n, h-index, w-index, c), or (w-index, h-index) for w > h."""
    if u.shape[2] > u.shape[1]:
        return torch.einsum("bnlw,bnwic->bnlic", k_y, torch.einsum("bnih,bhwc->bnwic", k_x, u))
    return torch.einsum("bnih,bnhlc->bnilc", k_x, torch.einsum("bnlw,bhwc->bnhlc", k_y, u))


def phi_moments(u, k_x, k_y, w_in, mean_from=None, bb=None):
    """E[phi^2] and the mean of phi = bb . W_in per (b, n, d), f32: (ex2,
    mean), the mean from ``block_mean_c`` (``rounded_mean_c`` without
    mean_from)."""
    dt = u.dtype
    k_x, k_y = k_x.to(dt), k_y.to(dt)
    if bb is None:
        bb = _apply_pair(u, k_x, k_y)
    bbf = bb.float()
    g = torch.einsum("bnilc,bnile->bnce", bbf, bbf)
    wf = w_in.to(dt).float()
    mean_c = rounded_mean_c(u, k_x, k_y) if mean_from is None else block_mean_c(u, mean_from)
    mean = torch.einsum("bnc,cnd->bnd", mean_c, wf)
    ex2 = torch.einsum("cnd,bnce,end->bnd", wf, g / (u.shape[1] * u.shape[2]), wf)
    return ex2, mean


def fab_core_plain(u, k_x, k_y, w_in, w_o1, eps: float = 1e-5, mean_from=None):
    """Plain PyTorch version (``_batched_gram_core``): u [b, h, w, c],
    k_x [b, n, h, h], k_y [b, n, w, w], w_in [c, n, d], w_o1 [n, d, o] ->
    [b, h, w, o] in u's dtype, rounding a, bb, m, the bias and the output to
    it where ``_batched_gram_core`` does.

    mean_from: None, the function jitted alone (mean_c the rounded bb's);
    or the inputs of ``block_mean_c``, mean_c as the jitted JAX block takes
    it from values the core never sees. The variance is
    ``_batched_gram_core``'s, ``max(E[phi^2] - mean^2, 0)``: with the
    block's mean against E[phi^2] of the rounded bb it cancels to zero on
    flat features as in the jitted JAX block, which then scales the channel
    by rsqrt(eps) (``chip_smoke.py`` counts how often)."""
    dt = u.dtype
    k_x, k_y, w_in = k_x.to(dt), k_y.to(dt), w_in.to(dt)
    b, h, w, c = u.shape
    bb = _apply_pair(u, k_x, k_y)
    ex2, mean = phi_moments(u, k_x, k_y, w_in, mean_from, bb)
    inv = torch.rsqrt((ex2 - mean.square()).clamp_min(0.0) + eps)
    wf, w1f = w_in.float(), w_o1.float()
    m = torch.einsum("cnd,bnd,ndo->bnco", wf, inv, w1f).to(dt)
    bias = torch.einsum("bnd,ndo->bo", mean * inv, w1f).to(dt)[:, None, None, :]
    if w > h:
        return (torch.einsum("bnlic,bnco->blio", bb, m) - bias).transpose(1, 2).contiguous()
    return torch.einsum("bnilc,bnco->bilo", bb, m) - bias


class FabCoreFunction(torch.autograd.Function):
    """Kernel 2 with a gradient. The forward launches the kernel (the plain
    version for a CPU tensor) and saves its inputs as they were given,
    before the wrapper's casts: w_in and w_o1 are views of the 1x1 conv
    weights, so autograd maps their gradients back to ``in_proj`` and
    ``to_out[1]``, and kx_s, ky_s of a mean_from reach the low-rank kernels.
    The backward recomputes ``fab_core_plain`` from them under grad (the
    casts happen inside it) and returns that function's gradients. The JAX
    package has no backward kernel to port (XLA differentiates
    ``_batched_gram_core``), so none is written here."""

    @staticmethod
    def forward(ctx, u, k_x, k_y, w_in, w_o1, eps: float, *mean_from):
        ctx.save_for_backward(u, k_x, k_y, w_in, w_o1, *mean_from)
        ctx.eps = eps
        return _fab_core(u, k_x, k_y, w_in, w_o1, eps, mean_from or None)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            y = fab_core_plain(*inputs[:5], ctx.eps, tuple(inputs[5:]) or None)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad, allow_unused=True))
        out = [next(grads) if t.requires_grad else None for t in inputs]
        return tuple(out[:5]) + (None,) + tuple(out[5:])


def fab_fused_core(u, k_x, k_y, w_in, w_o1, eps: float = 1e-5, mean_from=None):
    """FAB core with the JAX kernel's shapes: u [b, h, w, c] (post-GN),
    k_x [b, n, h, h], k_y [b, n, w, w], w_in [c, n, d], w_o1 [n, d, o],
    mean_from None or (x, coef, kx_s, ky_s) as ``fab_core_plain`` (bf16; the
    kernel forms the mean from them) -> [b, h, w, o] in u's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises. With grad mode on and any of the
    tensors requiring grad the call goes through ``FabCoreFunction``, which
    launches the same kernel and carries the plain version's gradient."""
    tensors = (u, k_x, k_y, w_in, w_o1) + tuple(mean_from or ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FabCoreFunction.apply(u, k_x, k_y, w_in, w_o1, eps, *(mean_from or ()))
    return _fab_core(u, k_x, k_y, w_in, w_o1, eps, mean_from)


def _fab_core(u, k_x, k_y, w_in, w_o1, eps: float, mean_from):
    """The launch (or, for a CPU tensor, the plain version), without grad."""
    t0 = profiling.clock()
    if not _build.on_cuda(u, "fab_fused_core", k_x, k_y, w_in, w_o1, *(mean_from or ())):
        return fab_core_plain(u, k_x, k_y, w_in, w_o1, eps, mean_from)
    if u.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"fab_fused_core: unsupported dtype {u.dtype}")
    if u.dim() != 4 or not u.is_contiguous():
        raise ValueError("fab_fused_core: u must be contiguous [b, h, w, c]")
    if mean_from is not None and u.dtype != torch.bfloat16:
        raise ValueError("fab_fused_core: mean_from takes bf16")
    b, h, w, c = u.shape
    n, d, o = w_o1.shape
    expect = {"k_x": (k_x, (b, n, h, h)), "k_y": (k_y, (b, n, w, w)),
              "w_in": (w_in, (c, n, d)), "w_o1": (w_o1, (n, d, o))}
    if mean_from is not None:
        expect.update(zip(("x", "coef", "kx_s", "ky_s"), zip(
            mean_from, ((b, h, w, c), (b, 2, c), (b, n, h), (b, n, w)))))
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != u.device:
            raise ValueError(f"fab_fused_core: {name} must be {shape} on {u.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if not 0 < b <= 65535:
        raise ValueError(f"fab_fused_core: batch {b}; the grid takes 1 to 65535")
    lib = _build.library()
    bf16 = u.dtype == torch.bfloat16
    if bf16:
        limit = lib.lns_fab_core_bf16_limit(h, w, c, d, o)  # the kernel's own limits
        if limit:
            raise ValueError(f"fab_fused_core: bf16 at {h}x{w} c{c} d{d} o{o} needs "
                             f"{limit.decode()}")
    given = u, k_x, k_y, w_in, w_o1
    if bf16 and u.data_ptr() % 16:  # u's rows load by TMA, from a 16-byte boundary
        u = u.clone()
    kx, ky = (_k_rows(k_x, u.dtype, bf16), _k_rows(k_y, u.dtype, bf16))
    wi = w_in.to(u.dtype).contiguous()
    w1 = w_o1.float().contiguous()
    if w1.data_ptr() % 16:  # read as 16-byte vectors
        w1 = w1.clone()
    copies = _build.copy_bytes(*zip(given, (u, kx, ky, wi, w1)))
    buf = {k: torch.empty(shape, device=u.device, dtype=dt)
           for k, (shape, dt) in scratch_shapes(b, n, h, w, c, o, u.dtype).items()}
    ptrs = [None] * 6
    if bf16:  # the mean's inputs (x null: from u alone), its scratch and the Gram's
        mf = [None] * 4
        if mean_from is not None:
            x, coef, kx_s, ky_s = mean_from
            xr = x.to(u.dtype).contiguous()
            if xr.data_ptr() % 16:  # read as 16-byte vectors, as u
                xr = xr.clone()
            mf = [xr, coef.float().contiguous(), kx_s.float().contiguous(),
                  ky_s.float().contiguous()]
            copies += _build.copy_bytes(*zip(mean_from, mf))
        ptrs = [t if t is None else t.data_ptr() for t in mf + [buf["mean"], buf["gram"]]]
    out = torch.empty((b, h, w, o), device=u.device, dtype=u.dtype)
    rc = lib.lns_fab_core(
        _build.DTYPE_CODE[u.dtype], u.data_ptr(), kx.data_ptr(), ky.data_ptr(),
        wi.data_ptr(), w1.data_ptr(), *ptrs, buf["m"].data_ptr(), buf["bias"].data_ptr(),
        buf["bb"].data_ptr() if bf16 else None, out.data_ptr(), b, n, h, w, c, d, o,
        ctypes.c_float(eps), torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(rc, "lns_fab_core")
    profiling.launched("fab_core.fab_fused_core",
                       copies + sum(t.nbytes for t in buf.values()), t0)
    return out


def _k_rows(k, dtype, pad: bool):
    """k [b, n, s, s] contiguous in `dtype`; with `pad`, its rows zero-padded
    to a multiple of 8 elements (the bf16 kernels load it by TMA, whose
    row strides are multiples of 16 bytes)."""
    k = k.to(dtype).contiguous()
    extra = -k.shape[-1] % 8
    return torch.nn.functional.pad(k, (0, extra)) if pad and extra else k


def bf16_plan(h, w, c, d, o, n) -> dict:
    """The bf16 kernels' launch plan for a shape (``chip_smoke.py`` prints
    it): the statistics pass's cluster size, tile columns, u rows per ring
    stage and stages, tiles, its shared memory per block and the output
    pass's, the padded c, the statistics clusters the card holds at once and
    the moments pass's shared memory."""
    out = (ctypes.c_int * 10)()
    _build.check(_build.library().lns_fab_core_bf16_plan(h, w, c, d, o, n, out),
                 "lns_fab_core_bf16_plan")
    keys = ("cluster", "tile_cols", "ring_rows", "ring_stages", "tiles", "stats_smem",
            "out_smem", "cp", "active_clusters", "moments_smem")
    return dict(zip(keys, out))
