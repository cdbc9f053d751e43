"""The second path of the port: the NS2d model with attention in the encoder
(``use_attn_enc: true``, the reference's autoencoder2d.py encoder-FA branch),
whose FAB blocks take the d-space core, against the JAX package in f32.

Tolerance 3e-4, the JAX package's own bound for the whole AE / predict
against the torch reference (tests/test_torch_export.py:48,74), as
test_torch_port_rollout.py uses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lns_tpu.config import Config as JConfig
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu_torch.config import Config
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.ops.factorized_attention import FABlock2D
from lns_tpu_torch.utils.convert import state_dict_from_jax

from _torch_port import load, perturb, small_ns2d_dict

STEPS, DECODE_CHUNK = 3, 4


@pytest.fixture(scope="module")
def models():
    d = {**small_ns2d_dict(), "use_attn_enc": True}
    jmodel = JLatentDynamics(JConfig(d))
    init = jax.jit(lambda key: jmodel.init(key, (1, 32, 32, 1)))
    params = perturb(init(jax.random.PRNGKey(8))["params"], 9, 0.02)
    model = load(LatentDynamics(Config(d), device="cpu"), state_dict_from_jax(Config(d), params))
    x = np.random.default_rng(10).standard_normal((3, 32, 32, 1)).astype(np.float32)
    return jmodel, params, model, x


def test_encoder_has_dspace_fab_blocks(models):
    """The small model's encoder gains FABs at 16x16 c32 and 8x8 c64 with
    dim_head 16: 5 c >= 9 d, so both take the d-space core, as in JAX."""
    model = models[2]
    impls = [(m.in_norm.weight.numel(), m.impl) for m in model.vq_ae.encoder.modules()
             if isinstance(m, FABlock2D)]
    assert impls == [(32, "batched"), (64, "batched")]


def test_encode_matches_jax(models):
    jmodel, params, model, x = models
    ref = np.asarray(jmodel.encode({"params": params}, jnp.asarray(x)))
    for flag in (True, False):
        z = model.use_kernels(flag).encode(torch.from_numpy(x))
        np.testing.assert_allclose(z.detach().numpy(), ref, atol=3e-4, err_msg=f"kernels={flag}")
    model.use_kernels(True)


def test_predict_matches_jax(models):
    jmodel, params, model, x = models
    ref = np.asarray(jmodel.predict({"params": params}, jnp.asarray(x), STEPS,
                                    decode_chunk=DECODE_CHUNK, use_pallas=True,
                                    pallas_interpret=True))
    for flag in (True, False):
        out = model.use_kernels(flag).predict(torch.from_numpy(x), STEPS,
                                              decode_chunk=DECODE_CHUNK)
        assert out.shape == ref.shape == (3, STEPS, 32, 32, 1)
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-4, err_msg=f"kernels={flag}")
    model.use_kernels(True)
