"""The port's d-space FAB pieces against the JAX package, in f32 on the CPU:
the axial-apply kernels' wrappers (their plain versions on a CPU tensor)
against the Pallas kernels in interpret mode, the d-space core against
``FABlock2D._batched_core``, and the FAB dispatch rule.

Tolerances: the axial applies 5e-5, the bound tests/test_pallas_kernels.py
holds its axial kernels to (:38, :60); ``transpose_hw`` exactly (it moves
data); the d-space core rtol 2e-5, atol 2e-5 x max|out|, the FAB core's
bound (test_pallas_kernels.py:260); whole FAB blocks 1e-4, as
test_torch_port_ops.py holds the c-space block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lns_tpu.ops as jops
from lns_tpu.ops import factorized_attention as jfa
from lns_tpu.pallas_kernels import axial_attention as jaa
from lns_tpu.pallas_kernels import axial_fused as jaf
from lns_tpu.pallas_kernels import axial_pipeline as jap
from lns_tpu_torch.kernels import axial, axial_pipeline
from lns_tpu_torch.models.specs import LayerSpec
from lns_tpu_torch.ops import factorized_attention as tfa
from lns_tpu_torch.utils.convert import sequential_state_dict

from _torch_port import load, nchw, nhwc, perturb


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_in", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 8, 16, 64), (1, 8, 16, 8, 64)])
def test_fab_axial_in_matches_pallas(shape, with_in):
    b, n, h, w, d = shape
    rng = np.random.default_rng(20)
    kx, ky, phi = _normal(rng, b, n, h, h), _normal(rng, b, n, w, w), _normal(rng, *shape)
    ref = np.asarray(jaf.fab_axial_in_fused(*map(jnp.asarray, (kx, ky, phi)),
                                            with_instance_norm=with_in, interpret=True))
    out = axial.fab_axial_in_fused(*_t(kx, ky, phi), with_instance_norm=with_in)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)
    np.testing.assert_array_equal(
        axial.fab_axial_in_plain(*_t(kx, ky, phi), with_instance_norm=with_in).numpy(),
        out.numpy())


_AXIAL_SHAPES = [(3, 8, 12, 4, 64), (2, 16, 16, 8, 64), (2, 7, 15, 2, 128)]  # B, H, W, heads, d


@pytest.mark.parametrize("shape", _AXIAL_SHAPES)
def test_axial_kernel_apply_headmajor_matches_pallas(shape):
    b, h, w, heads, d = shape
    g = b * heads
    rng = np.random.default_rng(21)
    kx, ky, phi = _normal(rng, g, h, h), _normal(rng, g, w, w), _normal(rng, g, h, w, d)
    ref = np.asarray(jaa.axial_kernel_apply_headmajor(*map(jnp.asarray, (kx, ky, phi)),
                                                      interpret=True))
    out = axial.axial_kernel_apply_headmajor(*_t(kx, ky, phi))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("shape", _AXIAL_SHAPES)
def test_axial_kernel_apply_matches_pallas(shape):
    b, h, w, heads, d = shape
    rng = np.random.default_rng(22)
    kx, ky = _normal(rng, b, heads, h, h), _normal(rng, b, heads, w, w)
    phi = _normal(rng, b, h, w, heads * d)
    ref = np.asarray(jaa.axial_kernel_apply(*map(jnp.asarray, (kx, ky, phi)), heads,
                                            interpret=True))
    out = axial.axial_kernel_apply(*_t(kx, ky, phi), heads)
    assert out.shape == phi.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("shape", [(2, 2, 16, 64), (3, 1, 24, 40)])
def test_bmm_blockdiag_matches_pallas(shape):
    b, g, m, n = shape
    rng = np.random.default_rng(23)
    kb, x = _normal(rng, b, g, m, m), _normal(rng, *shape)  # kb need not be block-diagonal
    ref = np.asarray(jap.bmm_blockdiag(jnp.asarray(kb), jnp.asarray(x), interpret=True))
    out = axial_pipeline.bmm_blockdiag(*_t(kb, x))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("shape", [(2, 4, 8, 16, 64), (1, 3, 7, 5, 12)])
def test_transpose_hw_matches_pallas(shape):
    x = _normal(np.random.default_rng(24), *shape)
    ref = np.asarray(jap.transpose_hw(jnp.asarray(x), interpret=True))
    out = axial_pipeline.transpose_hw(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_blockdiag_embed_matches_jax():
    k = _normal(np.random.default_rng(25), 2, 8, 5, 5)
    for group in (1, 2, 4):
        np.testing.assert_array_equal(
            axial_pipeline.blockdiag_embed(torch.from_numpy(k), group).numpy(),
            np.asarray(jaf.blockdiag_embed(jnp.asarray(k), group)))


@pytest.mark.parametrize("final_transpose", [True, False])
@pytest.mark.parametrize("group", [None, 2])
def test_axial_apply_pipeline_matches_pallas(group, final_transpose):
    b, heads, h, w, d = 2, 4, 8, 16, 64
    rng = np.random.default_rng(26)
    kx, ky = _normal(rng, b, heads, h, h), _normal(rng, b, heads, w, w)
    phi = _normal(rng, b, heads, h, w, d)
    ref = np.asarray(jap.axial_apply_pipeline(*map(jnp.asarray, (kx, ky, phi)), group=group,
                                              final_transpose=final_transpose, interpret=True))
    out = axial_pipeline.axial_apply_pipeline(*_t(kx, ky, phi), group=group,
                                              final_transpose=final_transpose)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)
    # the same math as the fused kernel (columns first there; f32 sums in another order)
    fused = axial.axial_kernel_apply_headmajor(
        *_t(kx.reshape(-1, h, h), ky.reshape(-1, w, w), phi.reshape(-1, h, w, d)))
    fused = fused.reshape(b, heads, h, w, d)
    if not final_transpose:
        fused = fused.transpose(2, 3)
    np.testing.assert_allclose(out.numpy(), fused.numpy(), atol=5e-5)


@pytest.mark.parametrize("b,n,h,w,c,d", [(2, 4, 8, 16, 32, 16), (3, 8, 12, 8, 128, 64)])
def test_dspace_core_matches_batched_core(b, n, h, w, c, d):
    rng = np.random.default_rng(27)
    u = _normal(rng, b, h, w, c)
    kx, ky = _normal(rng, b, n, h, h, scale=1 / h), _normal(rng, b, n, w, w, scale=1 / w)
    w_in, w_o1 = _normal(rng, c, n, d, scale=c ** -0.5), _normal(rng, n, d, c, scale=d ** -0.5)
    ref = np.asarray(jops.FABlock2D._batched_core(*map(jnp.asarray, (u, kx, ky, w_in, w_o1))))
    tol = dict(rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    args = _t(u, kx, ky, w_in, w_o1)
    np.testing.assert_allclose(tfa.fab_dspace_core_plain(*args).numpy(), ref, **tol)
    # the kernel path (here its plain version: normalise, then project)
    np.testing.assert_allclose(tfa.fab_dspace_core(*args).numpy(), ref, **tol)


def test_fab_impl_for_matches_jax(monkeypatch):
    monkeypatch.delenv("LNS_TPU_FAB_IMPL", raising=False)
    for dim in (8, 16, 24, 32, 36, 48, 64, 96, 115, 116, 128, 256):
        for dim_head in (8, 16, 32, 64, 128):
            assert tfa._fab_impl_for(dim, dim_head) == jfa._fab_impl_for(256, dim, dim_head), \
                (dim, dim_head)


@pytest.mark.parametrize("dim,dim_head,impl", [(32, 16, "batched"), (16, 16, "batchedgram"),
                                               (128, 64, "batched")])
def test_fablock_each_core_matches_jax(dim, dim_head, impl):
    """A whole block on each side of the dispatch rule, non-square field."""
    heads, hw = 4, (8, 12)
    x = _normal(np.random.default_rng(28), 2, *hw, dim)
    jblk = jops.FABlock2D(dim, dim_head, dim_head, heads, dim)
    p = perturb(jblk.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 2)
    ref = np.asarray(jblk.apply({"params": p}, jnp.asarray(x)))
    kw = dict(dim=dim, dim_head=dim_head, latent_dim=dim_head, heads=heads, dim_out=dim)
    state = sequential_state_dict([LayerSpec(0, "fablock", tuple(sorted(kw.items())))],
                                  {"m0": p})
    blk = load(tfa.FABlock2D(dim, dim_head, dim_head, heads, dim),
               {k[2:]: v for k, v in state.items()})
    assert blk.impl == impl
    with torch.no_grad():
        for flag in (True, False):
            blk.use_kernel = flag
            np.testing.assert_allclose(nhwc(blk(nchw(x))), ref, atol=1e-4,
                                       err_msg=f"use_kernel={flag}")
