"""Fused latent rollout: every SimpleCNN propagator step of a prediction in
one CUDA C++ kernel launch (``csrc/prop_rollout.cu``; design notes there).

Replaces ``lns_tpu/pallas_kernels/prop_rollout.py: fused_rollout``
(``_rollout_kernel``, fed by ``pack_simple_cnn_params``). Each step: in-proj
1x1; per block GN1 -> 3x3 -> GELU -> dilated 3x3 -> GELU -> 3x3, residual;
GN1 -> 1x1 -> GELU -> 1x1, residual; then GN(groups) -> out 1x1. The carry
stays on chip across steps. Padding: circular, zeros, half_periodic_x,
half_periodic_y.

What bounds it on an H100: in principle tensor-core arithmetic (~183 MFLOP
per sample-step at NS2d, 0.17 ms for B32 x 29 steps, 1.37 ms for B256 x 29,
at 989 TFLOP/s); a sample's step is a chain of ~20 small dependent products.
bf16 has two plans, each its own kernel body, chosen by the C launcher from
the shape (no knob): where the shape fits the sample plan (C 128, H W <= 64,
C_lat 16: NS2d's latent) and B is more than the clusters the cluster plan
holds at once on the card (62 at NS2d's 8x8 on an H100), the sample plan;
else the cluster plan.

- The cluster plan (small B, bound by the chain's latency): a thread-block
  cluster of CL blocks per sample (CL = 4 at B32, 8 for B <= 8), each block
  computing C/CL channels of every layer as implicit GEMMs on tensor cores
  (``mma.sync``), bf16 activations exchanged through distributed shared
  memory, weights streamed per slice through a ``cp.async`` ring. It takes
  SW's 12x24 latent at C 128, C_lat 64 (222,112 bytes of shared memory per
  block).
- The sample plan (large B, bound in principle by the tensor cores' rate
  and the weights' L2 traffic, in practice by each warpgroup's chain of
  dependent products and epilogues): a block owns two whole samples, one
  per consumer warpgroup, each product one m64 x C ``wgmma`` tile with A
  from registers; GN and the hand-offs stay inside the warpgroup; a
  cluster of blocks shares one weight stream (TMA multicast into a ring of
  C x C chunks); NS2d's B256 runs as 128 blocks in one wave.

Each launch that takes the sample plan counts
``prop_rollout.fused_rollout.sample_plan``, and the wrapper names the plan
on the innermost open span (``lns.rollout``: plan, samples_per_block); it
learns the plan from the C side (``rollout_plan``) once per device and
shape. f32 keeps one block per sample on CUDA cores (the check path); one
sample's f32 activations live in shared memory where they fit (NS2d) and
else in a global-memory workspace that this wrapper allocates (SW's 12x24:
517,888 bytes per sample). The wrapper raises for a shape outside a
kernel's limits with the text of the C side's ``lns_prop_rollout_limit``,
and launches nothing.

The conditional propagator (``CondSimpleCNN``, path 5) has a third bf16
body of its own, the FiLM plan (``fused_cond_rollout``, fed by
``pack_cond_simple_cnn`` and each sample's conditioning ``cond_terms``):
the sample plan's design at C 128, C_lat 64, H W <= 128 with zero
padding, one sample per block at a time (one m64 half per consumer
warpgroup), the batch walked persistently, with the FiLM block's f32
stretch in registers. It names ``plan="film"`` on ``lns.rollout`` and
raises for another dtype or shape with the text of
``lns_prop_rollout_film_limit``; ``film_takes`` is the rollout driver's
test of whether a carry takes it, by that limit alone: the shape, never
the card's occupancy. It replaces no Pallas kernel: the JAX
package steps its conditional propagator as modules.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.kernels.group_norm import group_norm_swish_plain
from lns_tpu_torch.ops.activations import gelu
from lns_tpu_torch.utils import profiling

# counter of the launches that took the sample plan (beside the wrapper's
# ``.launches``)
SAMPLE_PLAN = "prop_rollout.fused_rollout.sample_plan"
_PLANS: dict = {}  # (device, B, H, W, C_lat, C, groups) -> rollout_plan

_WRAP = {  # padding mode -> (wrap rows, wrap columns)
    "circular": (1, 1),
    "zeros": (0, 0),
    "half_periodic_x": (0, 1),
    "half_periodic_y": (1, 0),
}


class PackedSimpleCNN(NamedTuple):
    """SimpleCNN weights in the layouts the kernel reads. Matrices and conv
    taps in the activation dtype, GN parameters and biases in f32."""
    in_w: torch.Tensor      # [C_lat, C]
    in_b: torch.Tensor      # [C]
    gn_s: torch.Tensor      # [n_block, 2, C]  (conv GN1, ffn GN1)
    gn_b: torch.Tensor      # [n_block, 2, C]
    conv_w: torch.Tensor    # [n_block, 3, 3, 3, C, C]  (conv, ky, kx, in, out)
    conv_b: torch.Tensor    # [n_block, 3, C]
    ffn_w: torch.Tensor     # [n_block, 2, C, C]  (in, out)
    out_gn_s: torch.Tensor  # [C]
    out_gn_b: torch.Tensor  # [C]
    out_w: torch.Tensor     # [C, C_lat]
    out_b: torch.Tensor     # [C_lat]


def pack_simple_cnn(cnn, dtype: torch.dtype = torch.float32) -> PackedSimpleCNN:
    """Pack the port's ``SimpleCNN`` (lns_tpu_torch.models.propagator)."""
    def mat(conv1x1):        # [O, I, 1, 1] -> [I, O]
        return conv1x1.weight[:, :, 0, 0].t().to(dtype)

    def hwio(conv):          # [O, I, 3, 3] -> [3, 3, I, O]
        return conv.weight.permute(2, 3, 1, 0).to(dtype)

    blocks = list(cnn.net)
    f32 = torch.float32
    with torch.no_grad():
        packed = PackedSimpleCNN(
            in_w=mat(cnn.in_proj),
            in_b=cnn.in_proj.bias.to(f32),
            gn_s=torch.stack([torch.stack([b.conv[0].weight, b.ffn[0].weight]) for b in blocks]).to(f32),
            gn_b=torch.stack([torch.stack([b.conv[0].bias, b.ffn[0].bias]) for b in blocks]).to(f32),
            conv_w=torch.stack([torch.stack([hwio(b.conv[j]) for j in (1, 3, 5)]) for b in blocks]),
            conv_b=torch.stack([torch.stack([b.conv[j].bias for j in (1, 3, 5)]) for b in blocks]).to(f32),
            ffn_w=torch.stack([torch.stack([mat(b.ffn[1]), mat(b.ffn[3])]) for b in blocks]),
            out_gn_s=cnn.out_proj[0].gn.weight.to(f32),
            out_gn_b=cnn.out_proj[0].gn.bias.to(f32),
            out_w=mat(cnn.out_proj[1]),
            out_b=cnn.out_proj[1].bias.to(f32),
        )
    return PackedSimpleCNN(*(t.detach().contiguous() for t in packed))


def _gn(x, scale, bias, groups, eps):
    """GroupNorm on [B, H, W, C], f32 single-pass statistics (variance
    clamped at 0), rounded once."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * scale + bias
    return y.to(x.dtype)


def _gelu(x):
    return F.gelu(x.float()).to(x.dtype)


def _conv3(x, w_hwio, bias, dil, padding_mode):
    """3x3 conv, stride 1, 'same' padding `dil`, on [B, H, W, C]; its
    product alone when `bias` is None."""
    wrap_y, wrap_x = _WRAP[padding_mode]
    xc = x.permute(0, 3, 1, 2)
    if wrap_x:
        xc = F.pad(xc, (dil, dil, 0, 0), mode="circular")
    if wrap_y:
        xc = F.pad(xc, (0, 0, dil, dil), mode="circular")
    pad = (0 if wrap_y else dil, 0 if wrap_x else dil)
    out = F.conv2d(xc, w_hwio.permute(3, 2, 0, 1), None, 1, pad, dil).permute(0, 2, 3, 1)
    return out if bias is None else out + bias.to(x.dtype)


def fused_rollout_plain(z0, packed: PackedSimpleCNN, steps: int, n_block: int,
                        dilation: int, padding_mode: str, groups: int = 32):
    """Plain PyTorch version of the rollout, with the kernel's rounding
    points: z0 [B, H, W, C_lat] -> [steps, B, H, W, C_lat] in the packed
    weights' dtype."""
    p = packed
    dt = p.in_w.dtype
    z = z0.to(dt)
    outs = []
    for _ in range(steps):
        h = torch.matmul(z, p.in_w) + p.in_b.to(dt)
        for i in range(n_block):
            t = _gn(h, p.gn_s[i, 0], p.gn_b[i, 0], 1, 1e-5)
            t = _gelu(_conv3(t, p.conv_w[i, 0], p.conv_b[i, 0], 1, padding_mode))
            t = _gelu(_conv3(t, p.conv_w[i, 1], p.conv_b[i, 1], dilation, padding_mode))
            h = h + _conv3(t, p.conv_w[i, 2], p.conv_b[i, 2], 1, padding_mode)
            f = _gn(h, p.gn_s[i, 1], p.gn_b[i, 1], 1, 1e-5)
            h = h + torch.matmul(_gelu(torch.matmul(f, p.ffn_w[i, 0])), p.ffn_w[i, 1])
        h = _gn(h, p.out_gn_s, p.out_gn_b, groups, 1e-6)
        z = torch.matmul(h, p.out_w) + p.out_b.to(dt)
        outs.append(z)
    return torch.stack(outs)


def fused_rollout(z0, packed: PackedSimpleCNN, steps: int, n_block: int,
                  dilation: int, padding_mode: str, groups: int = 32):
    """Run `steps` SimpleCNN applications: z0 [B, H, W, C_lat] ->
    [steps, B, H, W, C_lat] (step-major, like the JAX kernel) in the packed
    weights' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(z0, "fused_rollout", *packed):
        profiling.annotate(plan="plain", samples_per_block=None)
        return fused_rollout_plain(z0, packed, steps, n_block, dilation, padding_mode, groups)
    if padding_mode not in _WRAP:
        raise ValueError(f"fused_rollout: unsupported padding mode {padding_mode}")
    dt = packed.in_w.dtype
    if dt not in _build.DTYPE_CODE:
        raise TypeError(f"fused_rollout: unsupported dtype {dt}")
    if z0.dim() != 4:
        raise ValueError("fused_rollout: z0 must be [B, H, W, C_lat]")
    b, h, w, c_lat = z0.shape
    c = packed.in_w.shape[1]
    _check_packed("fused_rollout", z0, packed, n_block, 2)
    lib = _build.library()
    limit = lib.lns_prop_rollout_limit(_build.DTYPE_CODE[dt], b, h, w, c_lat, c, groups)
    if limit:  # the kernel's own limits
        raise ValueError(f"fused_rollout: {str(dt)[6:]} at B{b} {h}x{w} C_lat {c_lat} C {c} "
                         f"groups {groups} needs {limit.decode()}")
    plan = (_plan_of(z0.device, b, h, w, c_lat, c, groups) if dt == torch.bfloat16
            else {"plan": "f32", "samples_per_block": 1})
    (z, *weights), copies = _aligned(z0, dt, packed)
    out = torch.empty((steps, b, h, w, c_lat), device=z0.device, dtype=dt)
    ws_bytes = lib.lns_prop_rollout_workspace(_build.DTYPE_CODE[dt], b, h, w, c_lat, c)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=z0.device) if ws_bytes else None
    wrap_y, wrap_x = _WRAP[padding_mode]
    rc = lib.lns_prop_rollout(
        _build.DTYPE_CODE[dt], z.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, h, w, c_lat, c, n_block, dilation, wrap_y,
        wrap_x, groups, steps, torch.cuda.current_stream(z0.device).cuda_stream)
    _build.check(rc, f"lns_prop_rollout(H*W={h * w}, C={c}, C_lat={c_lat}, groups={groups})")
    if plan["plan"] == "samples":
        profiling.count(SAMPLE_PLAN)
    profiling.annotate(plan=plan["plan"], samples_per_block=plan["samples_per_block"])
    profiling.launched("prop_rollout.fused_rollout", ws_bytes + copies, t0)
    return out


def _check_packed(name, z0, packed, n_block, norms, **f32):
    """Raise unless each tensor of `packed` (a block's `norms` GroupNorms)
    and of `f32` ({arg: (tensor, shape)}) is contiguous, on z0's device and
    of its layout's shape and dtype: the matrices and conv taps in the
    packed dtype, the rest f32."""
    c_lat, c = z0.shape[-1], packed.in_w.shape[1]
    shapes = {
        "in_w": (c_lat, c), "in_b": (c,), "gn_s": (n_block, norms, c),
        "gn_b": (n_block, norms, c), "conv_w": (n_block, 3, 3, 3, c, c),
        "conv_b": (n_block, 3, c), "ffn_w": (n_block, 2, c, c), "out_gn_s": (c,),
        "out_gn_b": (c,), "out_w": (c, c_lat), "out_b": (c_lat,),
    }
    tensors = {arg: (getattr(packed, arg), shape) for arg, shape in shapes.items()}
    for arg, (t, shape) in {**tensors, **f32}.items():
        want = packed.in_w.dtype if arg in ("in_w", "conv_w", "ffn_w", "out_w") else torch.float32
        if (tuple(t.shape) != tuple(shape) or t.dtype != want or t.device != z0.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous {want} {tuple(shape)} on "
                             f"{z0.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _aligned(z0, dt, tensors):
    """z0 in `dt` and contiguous, then `tensors`, each on a 16-byte boundary
    (the kernels read them as 16-byte vectors, the wgmma plans through
    tensor maps too), cloned where not; and the bytes of those copies."""
    given = (z0.to(dt).contiguous(), *tensors)
    used = [t if t.data_ptr() % 16 == 0 else t.clone() for t in given]
    return used, _build.copy_bytes((z0, used[0]), *zip(given[1:], used[1:]))


def rollout_plan(b: int, h: int, w: int, c_lat: int, c: int, groups: int = 32) -> dict:
    """The bf16 kernel's launch at this shape on the current card: the plan
    the C side chooses (``"cluster"`` or ``"samples"``), blocks per cluster,
    blocks, shared memory bytes per block, the clusters of this launch the
    card holds at once (``cudaOccupancyMaxActiveClusters``), the 16-row tiles
    per warp it is built for, the samples a block computes (a fraction in
    the cluster plan: 1 / cluster) and the weight ring's stages."""
    res = (ctypes.c_int * 8)()
    _build.check(_build.library().lns_prop_rollout_plan(b, h, w, c_lat, c, groups, res),
                 "lns_prop_rollout_plan")
    cluster, blocks, smem, at_once, tiles, samples, per_block, ring = res
    return {"plan": "samples" if samples else "cluster", "cluster": cluster, "blocks": blocks,
            "smem_bytes": smem, "max_active_clusters": at_once, "tiles_per_warp": tiles,
            "samples_per_block": per_block if samples else 1 / cluster, "ring_stages": ring}


def _plan_of(device, b, h, w, c_lat, c, groups) -> dict:
    """``rollout_plan`` of a bf16 launch on `device`, asked of the C side
    once per device and shape (the launcher makes the same choice itself)."""
    key = (device, b, h, w, c_lat, c, groups)
    plan = _PLANS.get(key)
    if plan is None:
        with torch.cuda.device(device):
            plan = _PLANS[key] = rollout_plan(b, h, w, c_lat, c, groups)
    return plan


class PackedCondSimpleCNN(NamedTuple):
    """CondSimpleCNN weights in the layouts the FiLM plan reads: those of
    ``PackedSimpleCNN``, a block's three GroupNorms and three convs in the
    order the step takes them."""
    in_w: torch.Tensor      # [C_lat, C]
    in_b: torch.Tensor      # [C]
    gn_s: torch.Tensor      # [n_block, 3, C]  (conv1.0, cond_conv1.0, ffn.0)
    gn_b: torch.Tensor      # [n_block, 3, C]
    conv_w: torch.Tensor    # [n_block, 3, 3, 3, C, C]  (conv1.1, conv1.3, cond_conv1.2)
    conv_b: torch.Tensor    # [n_block, 3, C]
    ffn_w: torch.Tensor     # [n_block, 2, C, C]  (ffn.1, ffn.3; in, out)
    out_gn_s: torch.Tensor  # [C]
    out_gn_b: torch.Tensor  # [C]
    out_w: torch.Tensor     # [C, C_lat]
    out_b: torch.Tensor     # [C_lat]


def pack_cond_simple_cnn(cnn, dtype: torch.dtype = torch.float32) -> PackedCondSimpleCNN:
    """Pack the port's ``CondSimpleCNN`` (lns_tpu_torch.models.propagator):
    matrices and conv taps in `dtype`, GroupNorm parameters and biases in
    f32. Its conditioning (``cond_emb``, ``cond_conv2``) is not packed: it
    enters as each sample's ``cond_terms``."""
    def mat(conv1x1):        # [O, I, 1, 1] -> [I, O]
        return conv1x1.weight[:, :, 0, 0].t().to(dtype)

    def hwio(conv):          # [O, I, 3, 3] -> [3, 3, I, O]
        return conv.weight.permute(2, 3, 1, 0).to(dtype)

    blocks = list(cnn.net)
    norms = [lambda b: b.conv1[0], lambda b: b.cond_conv1[0], lambda b: b.ffn[0]]
    convs = [lambda b: b.conv1[1], lambda b: b.conv1[3], lambda b: b.cond_conv1[2]]
    f32 = torch.float32
    with torch.no_grad():
        packed = PackedCondSimpleCNN(
            in_w=mat(cnn.in_proj),
            in_b=cnn.in_proj.bias.to(f32),
            gn_s=torch.stack([torch.stack([n(b).weight for n in norms]) for b in blocks]).to(f32),
            gn_b=torch.stack([torch.stack([n(b).bias for n in norms]) for b in blocks]).to(f32),
            conv_w=torch.stack([torch.stack([hwio(k(b)) for k in convs]) for b in blocks]),
            conv_b=torch.stack([torch.stack([k(b).bias for k in convs]) for b in blocks]).to(f32),
            ffn_w=torch.stack([torch.stack([mat(b.ffn[1]), mat(b.ffn[3])]) for b in blocks]),
            out_gn_s=cnn.out_proj[0].gn.weight.to(f32),
            out_gn_b=cnn.out_proj[0].gn.bias.to(f32),
            out_w=mat(cnn.out_proj[1]),
            out_b=cnn.out_proj[1].bias.to(f32),
        )
    return PackedCondSimpleCNN(*(t.detach().contiguous() for t in packed))


def cond_terms(shared):
    """``CondSimpleCNN.conditioning``'s result (each block's projection e
    and FiLM scale c, [B, C] f32) as the FiLM plan reads it: (e, c), each
    [n_block, B, C] f32."""
    return tuple(torch.stack([blk[k] for blk in shared]).float().contiguous() for k in (0, 1))


def fused_cond_rollout_plain(z0, packed: PackedCondSimpleCNN, e, c, steps: int, n_block: int,
                             dilation: int, padding_mode: str = "zeros", groups: int = 32):
    """Plain PyTorch version of the conditional rollout, with the FiLM
    plan's rounding points (the module step's; every GroupNorm's statistics
    single-pass in f32, the residual stream's bf16 ones applied as kernel 3
    does, ``_gn_module``, the f32 ones as ``_gn``): z0 [B, H, W, C_lat], e
    and c [n_block, B, C] f32 ->
    [steps, B, H, W, C_lat] in the packed weights' dtype. Per block: GN1 ->
    conv1.1 -> GELU -> conv1.3, whose product and bias are each rounded and
    summed in f32 with e; GN1 and GELU in f32, cast for cond_conv1.2 (g);
    the residual h + g rounded, the FiLM product (h + g)(1 + c) and its GN1
    in f32 from the unrounded sum; ffn.1 -> GELU -> ffn.3, residual."""
    p = packed
    dt = p.in_w.dtype
    z = z0.to(dt)
    ev, cv = (t.float()[:, :, None, None, :] for t in (e, c))
    outs = []
    for _ in range(steps):
        h = torch.matmul(z, p.in_w) + p.in_b.to(dt)
        for i in range(n_block):
            t = _gn_module(h, p.gn_s[i, 0], p.gn_b[i, 0], 1, 1e-5)
            t = gelu(_conv3(t, p.conv_w[i, 0], p.conv_b[i, 0], 1, padding_mode))
            u = (_conv3(t, p.conv_w[i, 1], None, dilation, padding_mode).float()
                 + p.conv_b[i, 1].to(dt).float() + ev[i])
            u = gelu(_gn(u, p.gn_s[i, 1], p.gn_b[i, 1], 1, 1e-5)).to(dt)
            g = _conv3(u, p.conv_w[i, 2], p.conv_b[i, 2], 1, padding_mode)
            f = _gn((h.float() + g.float()) * (1 + cv[i]), p.gn_s[i, 2], p.gn_b[i, 2], 1, 1e-5)
            h = (h + g) + torch.matmul(gelu(torch.matmul(f.to(dt), p.ffn_w[i, 0])), p.ffn_w[i, 1])
        h = _gn_module(h, p.out_gn_s, p.out_gn_b, groups, 1e-6)
        z = torch.matmul(h, p.out_w) + p.out_b.to(dt)
        outs.append(z)
    return torch.stack(outs)


def _gn_module(x, scale, bias, groups, eps):
    """A GroupNorm of the residual stream as the module computes it: bf16 as
    kernel 3 (``group_norm_swish_plain``: single-pass f32 statistics, sc and
    sh rounded, then x sc + sh in bf16), f32 as ``_gn``."""
    if x.dtype == torch.float32:
        return _gn(x, scale, bias, groups, eps)
    return group_norm_swish_plain(x, scale, bias, groups, eps, apply_swish=False)


def film_takes(z: torch.Tensor, c: int, padding_mode: str, groups: int = 32) -> bool:
    """Whether ``fused_cond_rollout`` launches the FiLM plan for the carry
    z [B, H, W, C_lat] of a conditional propagator of width `c`: a CUDA
    bf16 tensor, zero padding, and a shape the C side's limit takes
    (``lns_prop_rollout_film_limit``). Read from the input alone: nothing
    is asked of the card, so a launch that the card cannot take raises in
    ``fused_cond_rollout`` and never sends the carry to the module loop."""
    if z.device.type != "cuda" or z.dtype != torch.bfloat16 or z.dim() != 4 \
            or padding_mode != "zeros":
        return False
    return not _build.library().lns_prop_rollout_film_limit(*z.shape, c, groups)


def fused_cond_rollout(z0, packed: PackedCondSimpleCNN, e, c, steps: int, n_block: int,
                       dilation: int, padding_mode: str = "zeros", groups: int = 32):
    """Run `steps` CondSimpleCNN applications: z0 [B, H, W, C_lat], each
    sample's conditioning e and c [n_block, B, C] f32 (``cond_terms``) ->
    [steps, B, H, W, C_lat] (step-major) in the packed weights' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the FiLM
    plan on the current stream (bf16, zero padding, C 128, C_lat 64, H W <=
    128, groups 32) or raises: with the C side's limit text for another
    shape, with the launch's CUDA error where the card holds none of the
    plan's clusters."""
    t0 = profiling.clock()
    if not _build.on_cuda(z0, "fused_cond_rollout", e, c, *packed):
        profiling.annotate(plan="plain", samples_per_block=None)
        return fused_cond_rollout_plain(z0, packed, e, c, steps, n_block, dilation, padding_mode,
                                        groups)
    if padding_mode != "zeros":
        raise ValueError(f"fused_cond_rollout: the FiLM plan takes zero padding, got "
                         f"{padding_mode}")
    dt = packed.in_w.dtype
    if dt != torch.bfloat16:
        raise TypeError(f"fused_cond_rollout: the FiLM plan takes bfloat16 weights, got {dt}")
    if z0.dim() != 4:
        raise ValueError("fused_cond_rollout: z0 must be [B, H, W, C_lat]")
    b, h, w, c_lat = z0.shape
    ch = packed.in_w.shape[1]
    _check_packed("fused_cond_rollout", z0, packed, n_block, 3, e=(e, (n_block, b, ch)),
                  c=(c, (n_block, b, ch)))
    lib = _build.library()
    limit = lib.lns_prop_rollout_film_limit(b, h, w, c_lat, ch, groups)
    if limit:  # the kernel's own limits
        raise ValueError(f"fused_cond_rollout: bfloat16 at B{b} {h}x{w} C_lat {c_lat} C {ch} "
                         f"groups {groups} needs {limit.decode()}")
    args, copies = _aligned(z0, dt, (*packed, e, c))
    out = torch.empty((steps, b, h, w, c_lat), device=z0.device, dtype=dt)
    rc = lib.lns_prop_rollout_film(
        *(t.data_ptr() for t in args), out.data_ptr(), b, h, w, n_block, dilation, steps,
        torch.cuda.current_stream(z0.device).cuda_stream)
    _build.check(rc, f"lns_prop_rollout_film(B={b}, H*W={h * w}, n_block={n_block})")
    profiling.annotate(plan="film", samples_per_block=1)
    profiling.launched("prop_rollout.fused_cond_rollout", copies, t0)
    return out


def cond_rollout_plan(b: int, h: int, w: int) -> dict:
    """The FiLM plan's launch at this shape on the current card: blocks per
    cluster, blocks, shared memory bytes per block, the clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``), the weight ring's
    stages and the passes (samples each block walks in turn)."""
    res = (ctypes.c_int * 6)()
    _build.check(_build.library().lns_prop_rollout_film_plan(b, h, w, res),
                 "lns_prop_rollout_film_plan")
    cluster, blocks, smem, at_once, ring, passes = res
    return {"plan": "film", "cluster": cluster, "blocks": blocks, "smem_bytes": smem,
            "max_active_clusters": at_once, "ring_stages": ring, "passes": passes,
            "samples_per_block": 1}

