"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode, on the cases
tests/test_pallas_kernels.py holds them to, with the same tolerances:

  * GroupNorm(+swish): atol 2e-6 (test_pallas_kernels.py:24);
  * fused rollout: atol 2e-5 x max|z| (:193), f32 over 5 steps;
  * FAB core: rtol 2e-5, atol 2e-5 x max|out| (:260).

In bf16 the plain versions are pinned to the JAX package's rounding points,
which the Hopper kernels share (each bound is stated beside its test):

  * GroupNorm(+swish) against ``lns_tpu.ops.norms.GroupNorm`` and
    ``lns_tpu.ops.activations.swish``, what the JAX models run;
  * the c-space FAB core against ``FABlock2D._batched_gram_core``, also in
    the bf16 kernels' order of sums;
  * ``bmm_blockdiag`` and the fused rollout against the Pallas kernels in
    interpret mode.

The kernels themselves need a CUDA card; ``chip_smoke.py`` holds each one to
its plain version there. Here the wrappers must take the plain version for a
CPU tensor, refuse any other non-CUDA device, and count no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lns_tpu.models.propagator import SimpleCNN as JSimpleCNN
from lns_tpu.ops.activations import swish as jswish
from lns_tpu.ops.norms import GroupNorm as JGroupNorm
from lns_tpu.ops.factorized_attention import FABlock2D as JFABlock2D
from lns_tpu.pallas_kernels import axial_pipeline as jap
from lns_tpu.pallas_kernels import fab_core as jfab
from lns_tpu.pallas_kernels import group_norm as jgn
from lns_tpu.pallas_kernels import prop_rollout as jpr
from lns_tpu_torch.config import Config
from lns_tpu_torch.kernels import axial, axial_pipeline, fab_core, group_norm, prop_rollout
from lns_tpu_torch.models.propagator import SimpleCNN
from lns_tpu_torch.utils import profiling
from lns_tpu_torch.utils.convert import propagator_state_dict

from _torch_port import load, perturb

_COUNTED = ("group_norm.fused_group_norm_swish", "fab_core.fab_fused_core",
            "prop_rollout.fused_rollout", "axial.fab_axial_in_fused",
            "axial.axial_kernel_apply_headmajor", "axial_pipeline.bmm_blockdiag",
            "axial_pipeline.transpose_hw")


def _launches():
    """Each wrapper's launches so far, from the counter registry."""
    counts = profiling.counters()
    return [counts.get(f"{k}.launches", 0) for k in _COUNTED]


@pytest.mark.parametrize("groups,eps,swish,shape", [
    (32, 1e-6, True, (3, 16, 16, 64)),
    (8, 1e-5, True, (2, 16, 16, 64)),
    (1, 1e-5, False, (2, 12, 20, 64)),
])
def test_group_norm_matches_pallas(groups, eps, swish, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    ref = jgn.fused_group_norm_swish(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     groups, eps=eps, apply_swish=swish, interpret=True)
    out = group_norm.fused_group_norm_swish(torch.from_numpy(x), torch.from_numpy(scale),
                                            torch.from_numpy(bias), groups, eps, swish)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def _bf16_ulp(v):
    """Spacing of bf16 values at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("groups,eps,swish,spatial,c", [
    (32, 1e-6, True, (8, 8), 128),
    (32, 1e-6, True, (16, 16), 64),
    (8, 1e-5, True, (32, 32), 64),
    (1, 1e-5, False, (16, 16), 64),
    (32, 1e-6, True, (7, 15), 64),
])
def test_group_norm_plain_bf16_rounds_as_jax_groupnorm(groups, eps, swish, spatial, c):
    """bf16 in, bf16 out: the plain version (and so the kernel it holds on the
    card) against ``norms.GroupNorm`` (+ ``swish``) in bf16. Both round sc,
    sh, the product, the sum and every op of the swish at the same points;
    only the order of the f32 sums differs, which can move one (sample,
    channel)'s sc or sh by one bf16 ulp and so some of that channel's
    elements by one ulp: at most 1 / (B C) of the elements per such channel
    (0.39 % at B4 C64). Bound: at most 0.5 % of the elements differ, each by
    at most one bf16 ulp of the element (measured 0 % at these cases; before
    the repair, with f32 two-pass statistics and one rounding, 42-56 %
    differed)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, *spatial, c)) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ref = JGroupNorm(groups, c, eps=eps).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, jnp.bfloat16))
    if swish:
        ref = jswish(ref)
    ref = np.asarray(ref.astype(jnp.float32))
    out = group_norm.group_norm_swish_plain(torch.from_numpy(x).to(torch.bfloat16),
                                            torch.from_numpy(scale), torch.from_numpy(bias),
                                            groups, eps, swish)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    out = out.float().numpy()
    assert (out != ref).mean() <= 0.005
    assert np.all(np.abs(out - ref) <= np.maximum(_bf16_ulp(ref), _bf16_ulp(out)))


@pytest.mark.parametrize(
    "pm,h,w,c_lat",
    [("circular", 8, 8, 16), ("zeros", 7, 15, 64), ("half_periodic_x", 12, 24, 64)],
)
def test_fused_rollout_matches_pallas(pm, h, w, c_lat):
    nb, c, dil, steps, b = 2, 64, 2, 5, 2
    jmodel = JSimpleCNN(latent_dim=c_lat, prop_n_block=nb, prop_n_embd=c, dilation=dil,
                        padding_mode=pm, dtype=jnp.float32)
    z0 = np.random.default_rng(1).standard_normal((b, h, w, c_lat)).astype(np.float32)
    params = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(z0))["params"], 2,
                     scale=0.05)
    packed = jpr.pack_simple_cnn_params(params, nb, dtype=jnp.float32)
    ref = np.asarray(jpr.fused_rollout(jnp.asarray(z0), packed, steps=steps, n_block=nb,
                                       dilation=dil, padding_mode=pm, interpret=True))

    # the port's SimpleCNN holds the weights; the padding mode is the kernel's argument
    cnn = load(SimpleCNN(c_lat, nb, c, dil, padding_mode="circular"),
               propagator_state_dict(Config(prop_n_block=nb), params))
    zs = prop_rollout.fused_rollout(torch.from_numpy(z0), prop_rollout.pack_simple_cnn(cnn),
                                    steps, nb, dil, pm)
    assert zs.shape == (steps, b, h, w, c_lat)
    np.testing.assert_allclose(zs.numpy(), ref, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize(
    "pm,h,w,c_lat",
    [("circular", 8, 8, 16), ("half_periodic_x", 12, 24, 64), ("zeros", 7, 15, 64)],
)
def test_fused_rollout_plain_bf16_matches_pallas(pm, h, w, c_lat):
    """bf16 weights and activations, one step: the plain version (and so the
    kernel it holds on the card) rounds where the Pallas kernel does, but
    its f32 sums run in other orders, and a value that lands one bf16 ulp
    away moves the next GroupNorm, conv and GELU: about 80 % of the elements
    differ, by at most ~1.2 % of max|ref| (measured 1.0-1.2 % at these
    shapes). The JAX package's own XLA ``SimpleCNN`` in bf16 differs from
    its Pallas kernel by the same (1.0-1.2 %, 81-83 % of the elements), so
    the bound is 2e-2 x max|ref|, the one ``chip_smoke.py`` holds the kernel
    to against the plain version."""
    nb, c, dil, b = 2, 64, 2, 2
    jmodel = JSimpleCNN(latent_dim=c_lat, prop_n_block=nb, prop_n_embd=c, dilation=dil,
                        padding_mode=pm, dtype=jnp.float32)
    z0 = np.random.default_rng(1).standard_normal((b, h, w, c_lat)).astype(np.float32)
    params = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(z0))["params"], 2,
                     scale=0.05)
    packed = jpr.pack_simple_cnn_params(params, nb, dtype=jnp.bfloat16)
    ref = jpr.fused_rollout(jnp.asarray(z0, jnp.bfloat16), packed, steps=1, n_block=nb,
                            dilation=dil, padding_mode=pm, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))

    cnn = load(SimpleCNN(c_lat, nb, c, dil, padding_mode="circular"),
               propagator_state_dict(Config(prop_n_block=nb), params))
    zs = prop_rollout.fused_rollout_plain(torch.from_numpy(z0).to(torch.bfloat16),
                                          prop_rollout.pack_simple_cnn(cnn, torch.bfloat16),
                                          1, nb, dil, pm)
    assert zs.dtype == torch.bfloat16 and zs.shape == (1, b, h, w, c_lat)
    np.testing.assert_allclose(zs.float().numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("b,n,h,w,c", [(4, 8, 16, 16, 32), (3, 4, 12, 24, 16),
                                       (3, 4, 24, 12, 16)])
def test_fab_core_matches_pallas(b, n, h, w, c):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kx = (rng.standard_normal((b, n, h, h)) / h).astype(np.float32)
    ky = (rng.standard_normal((b, n, w, w)) / w).astype(np.float32)
    w_in = (rng.standard_normal((c, n, c)) / np.sqrt(c)).astype(np.float32)
    w_o1 = (rng.standard_normal((n, c, c)) / np.sqrt(c)).astype(np.float32)
    ref = np.asarray(jfab.fab_fused_core(*map(jnp.asarray, (u, kx, ky, w_in, w_o1)),
                                         interpret=True))
    out = fab_core.fab_fused_core(*map(torch.from_numpy, (u, kx, ky, w_in, w_o1)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def _fab_inputs(seed, b, n, h, w, c):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kx = (rng.standard_normal((b, n, h, h)) / h).astype(np.float32)
    ky = (rng.standard_normal((b, n, w, w)) / w).astype(np.float32)
    w_in = (rng.standard_normal((c, n, c)) / np.sqrt(c)).astype(np.float32)
    w_o1 = (rng.standard_normal((n, c, c)) / np.sqrt(c)).astype(np.float32)
    return u, kx, ky, w_in, w_o1


@pytest.mark.parametrize("b,n,h,w,c", [(2, 8, 16, 16, 32), (3, 4, 12, 24, 16),
                                       (3, 4, 24, 12, 16), (1, 4, 24, 48, 64),
                                       (1, 2, 48, 96, 64)])
def test_fab_core_plain_bf16_rounds_as_batched_gram_core(b, n, h, w, c):
    """bf16 in, bf16 out: the plain version (and so the kernel it holds on the
    card) rounds a, bb, m, the bias and the output to bf16 where
    ``_batched_gram_core`` does. The f32 sums run in other orders, so a value
    near a rounding boundary may land one bf16 ulp away and carry on: at
    most 1e-2 x max|ref| (about one ulp of the largest value) and at most 1 %
    of the elements differ (measured <= 0.5 %; with a, bb and m kept in f32
    instead, ~60 % differ and the largest error is ~2x)."""
    u, kx, ky, w_in, w_o1 = _fab_inputs(11, b, n, h, w, c)
    bf = jnp.bfloat16
    ref = JFABlock2D._batched_gram_core(jnp.asarray(u, bf), jnp.asarray(kx, bf),
                                        jnp.asarray(ky, bf), jnp.asarray(w_in, bf),
                                        jnp.asarray(w_o1))
    ref = np.asarray(ref.astype(jnp.float32))
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (u, kx, ky, w_in)]
    out = fab_core.fab_core_plain(*args, torch.from_numpy(w_o1))
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, w, c)
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    assert (out != ref).mean() <= 0.01


def _fab_core_kernel_order(u, k_x, k_y, w_in, w_o1, eps=1e-5, mean_from=None):
    """``fab_core_plain`` in the bf16 kernels' order of sums
    (``csrc/fab_core.cu``): bb formed once and kept in the scratch's layout
    [b, n, h, w, cp] (c zero-padded to whole 64-channel atoms); the Gram as
    two partial sums over alternate 16-pixel steps (the two warpgroups, in
    the kernels' pixel order: the k_y-applied axis outer, the other padded
    to 16) added once; the output as one product over K = n cp in f32; the
    heads' biases summed in head order in f32."""
    dt = u.dtype
    k_x, k_y, w_in = k_x.to(dt), k_y.to(dt), w_in.to(dt)
    b, h, w, c = u.shape
    n, d, o = w_o1.shape
    cp = -(-c // 64) * 64
    bb = fab_core._apply_pair(u, k_x, k_y)  # rounded to bf16 at a and bb
    bk = torch.nn.functional.pad(bb, (0, cp - c))  # the kernels' field: [b, n, hk, wk, cp]
    hk, wk = bk.shape[2:4]
    hp = -(-hk // 16) * 16
    px = torch.nn.functional.pad(bk.transpose(2, 3), (0, 0, 0, hp - hk))  # [b, n, wk, hp, cp]
    steps = px.reshape(b, n, -1, 16, cp).float()
    g = [torch.einsum("bnskc,bnske->bnce", steps[:, :, k::2], steps[:, :, k::2]) for k in (0, 1)]
    gram = (g[0] + g[1])[:, :, :c, :c]
    mean_c = (fab_core.rounded_mean_c(u, k_x, k_y) if mean_from is None
              else fab_core.block_mean_c(u, mean_from))
    wf, w1f = w_in.float(), w_o1.float()
    mean = torch.einsum("bnc,cnd->bnd", mean_c, wf)
    ex2 = torch.einsum("cnd,bnce,end->bnd", wf, gram, wf) / (h * w)
    inv = torch.rsqrt((ex2 - mean.square()).clamp_min(0.0) + eps)
    m = torch.einsum("cnd,bnd,ndo->bnco", wf, inv, w1f).to(dt)
    m = torch.nn.functional.pad(m, (0, 0, 0, cp - c))  # [b, n, cp, o]
    bias = torch.einsum("bnd,ndo->bno", mean * inv, w1f)
    bsum = bias[:, 0]
    for k in range(1, n):
        bsum = bsum + bias[:, k]
    scratch = bk if w <= h else bk.transpose(2, 3)  # [b, n, h, w, cp]
    acc = scratch.permute(0, 2, 3, 1, 4).reshape(b, h * w, n * cp).float() @ \
        m.reshape(b, n * cp, o).float()
    out = acc.to(dt).float() - bsum.to(dt).float()[:, None]
    return out.to(dt).reshape(b, h, w, o)


@pytest.mark.parametrize("b,n,h,w,c,block_mean", [
    (2, 8, 16, 16, 64, False), (2, 8, 16, 16, 64, True), (1, 4, 24, 48, 64, True),
    (2, 4, 12, 24, 96, False), (2, 4, 15, 31, 32, True), (1, 2, 48, 96, 64, False)])
def test_fab_core_kernel_order_bf16(b, n, h, w, c, block_mean):
    """The bf16 kernels sum in another order than ``fab_core_plain`` (bb
    stored once, the Gram in two partial sums, the heads as one K = n cp
    product, the bias summed head by head): that order, emulated in plain
    PyTorch, stays within the bounds ``chip_smoke.py`` holds the kernel to
    (1e-2 x max|plain| and at most 2 % of the elements differing) against
    ``fab_core_plain`` and, for mean_c from u, the jitted JAX
    ``_batched_gram_core`` in bf16; the mean from the block's GroupNorm
    inputs (``block_mean_c``) against ``fab_core_plain`` with the same."""
    u, kx, ky, w_in, w_o1 = _fab_inputs(17, b, n, h, w, c)
    bf = torch.bfloat16
    args = [torch.from_numpy(a).to(bf) for a in (u, kx, ky, w_in)] + [torch.from_numpy(w_o1)]
    mf = None
    if block_mean:  # x, the GroupNorm(1)'s sc and sh, the kernels' f32 sums (as FABlock2D)
        rng = np.random.default_rng(18)
        x = torch.from_numpy(1.5 * rng.standard_normal((b, h, w, c)).astype(np.float32) + 0.3)
        x = x.to(bf)
        sc = torch.from_numpy(1 + 0.2 * rng.standard_normal((b, c)).astype(np.float32)).to(bf)
        sh = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32)).to(bf)
        args[0] = x * sc[:, None, None] + sh[:, None, None]
        sums = [k.float().sum(2) * (1 + 0.05 * torch.from_numpy(
            rng.standard_normal(k.shape[:3]).astype(np.float32))) for k in args[1:3]]
        mf = (x, torch.stack([sc, sh], 1).float(), *sums)
    out = _fab_core_kernel_order(*args, mean_from=mf)
    assert out.dtype == bf and out.shape == (b, h, w, w_o1.shape[-1])
    refs = [fab_core.fab_core_plain(*args, mean_from=mf).float().numpy()]
    if not block_mean:
        jref = jax.jit(JFABlock2D._batched_gram_core)(
            *(jnp.asarray(a, jnp.bfloat16) for a in (u, kx, ky, w_in)), jnp.asarray(w_o1))
        refs.append(np.asarray(jref.astype(jnp.float32)))
    out = out.float().numpy()
    assert np.isfinite(out).all()
    for ref in refs:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
        assert (out != ref).mean() <= 0.02


def test_block_mean_reads_the_unrounded_group_norm():
    """``block_mean_c`` forms mean_c from T(x sc) + sh in f32 (the GroupNorm
    output before its last rounding, whose rounding gives u) and the f32
    sums of the kernels: against the f32 einsum of those values, and not
    the mean of the rounded u. Its gradient is u's: the same as mean_c
    from u with those sums (the rounding residue carries none)."""
    rng = np.random.default_rng(5)
    b, n, h, w, c = 2, 3, 6, 5, 16
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(c).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(c).astype(np.float32))
    u, coef = group_norm.group_norm_swish_plain(x, scale, bias, 1, 1e-5, apply_swish=False,
                                                with_coef=True)
    assert torch.equal(u, group_norm.group_norm_swish_plain(x, scale, bias, 1, 1e-5, False))
    sc, sh = coef[:, 0].bfloat16(), coef[:, 1].bfloat16()
    assert torch.equal(coef, torch.stack([sc, sh], 1).float())
    uf = (x * sc[:, None, None]).float() + sh[:, None, None].float()
    assert torch.equal(uf.bfloat16(), u) and not torch.equal(uf, u.float())
    kx_s = torch.from_numpy(rng.standard_normal((b, n, h)).astype(np.float32))
    ky_s = torch.from_numpy(rng.standard_normal((b, n, w)).astype(np.float32))
    ur = u.clone().requires_grad_()
    mean = fab_core.block_mean_c(ur, (x, coef, kx_s, ky_s))
    want = torch.einsum("bnh,bnw,bhwc->bnc", kx_s, ky_s, uf) / (h * w)
    assert torch.equal(mean, want)
    gm = torch.from_numpy(rng.standard_normal(mean.shape).astype(np.float32))
    mean.backward(gm)
    u2 = u.clone().requires_grad_()
    (torch.einsum("bnh,bnw,bhwc->bnc", kx_s, ky_s, u2.float()) / (h * w)).backward(gm)
    assert torch.equal(ur.grad, u2.grad)


@pytest.mark.parametrize("m,n", [(16, 40), (24, 96), (20, 37), (8, 3)])
def test_bmm_blockdiag_plain_bf16_matches_pallas(m, n):
    """bf16: both sum in f32 and round once, so an element differs only where
    the f32 sums in other orders straddle a rounding boundary: one bf16 ulp,
    at most 2**-7 x max|ref|."""
    rng = np.random.default_rng(m)
    kb = (rng.standard_normal((2, 3, m, m)) / np.sqrt(m)).astype(np.float32)
    x = rng.standard_normal((2, 3, m, n)).astype(np.float32)
    bf = jnp.bfloat16
    ref = jap.bmm_blockdiag(jnp.asarray(kb, bf), jnp.asarray(x, bf), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = axial_pipeline.bmm_blockdiag(torch.from_numpy(kb).to(torch.bfloat16),
                                       torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2**-7 * np.abs(ref).max())


def test_wrappers_count_no_launch_on_cpu():
    before = _launches()
    x = torch.randn(2, 8, 8, 64)
    group_norm.fused_group_norm_swish(x, torch.ones(64), torch.zeros(64), 32)
    fab_core.fab_fused_core(x, torch.randn(2, 2, 8, 8), torch.randn(2, 2, 8, 8),
                            torch.randn(64, 2, 8), torch.randn(2, 8, 64))
    cnn = SimpleCNN(16, 1, 32, 2)
    prop_rollout.fused_rollout(torch.randn(2, 4, 4, 16), prop_rollout.pack_simple_cnn(cnn),
                               2, 1, 2, "circular")
    phi = torch.randn(2, 2, 8, 8, 16)
    axial.fab_axial_in_fused(torch.randn(2, 2, 8, 8), torch.randn(2, 2, 8, 8), phi)
    axial.fab_axial_in_fused(torch.randn(2, 2, 8, 8), torch.randn(2, 2, 8, 8), phi,
                             with_instance_norm=False, stats=True)
    axial.axial_kernel_apply(torch.randn(2, 2, 8, 8), torch.randn(2, 2, 8, 8), x, 2)
    axial_pipeline.axial_apply_pipeline(torch.randn(2, 2, 8, 8), torch.randn(2, 2, 8, 8), phi)
    assert _launches() == before == [0] * len(_COUNTED)


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA is refused, never computed some other way."""
    x = torch.empty(2, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        group_norm.fused_group_norm_swish(x, torch.ones(64), torch.zeros(64), 32)
    with pytest.raises(ValueError, match="device"):
        fab_core.fab_fused_core(x, x, x, x, x)
    cnn = SimpleCNN(16, 1, 32, 2)
    with pytest.raises(ValueError, match="device"):
        prop_rollout.fused_rollout(torch.empty(2, 4, 4, 16, device="meta"),
                                   prop_rollout.pack_simple_cnn(cnn), 2, 1, 2, "circular")
    k = torch.empty(2, 2, 8, 8, device="meta")
    phi = torch.empty(2, 2, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        axial.fab_axial_in_fused(k, k, phi)
    with pytest.raises(ValueError, match="device"):
        axial.fab_axial_in_fused(k, k, phi, with_instance_norm=False, stats=True)
    with pytest.raises(ValueError, match="device"):
        axial.axial_kernel_apply_headmajor(k[0], k[0], phi[0])
    with pytest.raises(ValueError, match="device"):
        axial.axial_kernel_apply(k, k, x, 2)
    with pytest.raises(ValueError, match="device"):
        axial_pipeline.bmm_blockdiag(k, phi.reshape(2, 2, 8, 128))
    with pytest.raises(ValueError, match="device"):
        axial_pipeline.transpose_hw(phi)
    with pytest.raises(ValueError, match="device"):
        axial_pipeline.axial_apply_pipeline(k, k, phi)
