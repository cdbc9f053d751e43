"""The port's whole inference path (``LatentDynamics.predict``: encode ->
propagator steps -> chunked decode) against the JAX package's ``predict``,
on the same converted parameters and numpy inputs.

f32, tolerance 3e-4: the JAX package's own bound for the whole AE / predict
against the torch reference (tests/test_torch_export.py:48,74). bf16, one
propagator step only (a bf16 rollout drifts with rounding like any other,
``latent_dynamics.py:152-156``): 2e-2 x max|z|. The module step's GroupNorm
rounds where ``norms.GroupNorm`` does (``group_norm_swish_plain``), but GELU
and the convolutions' sums round at other points, so the step still differs
by about 1e-2 x max|z| (0.99e-2 at this test's inputs, 0.86e-2 before the
GroupNorm repair: no tighter bound holds); the JAX package's own bf16 step
differs from its f32 step by about as much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lns_tpu.config import Config as JConfig
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.models.propagator import SimpleCNN as JSimpleCNN
from lns_tpu_torch.config import Config
from lns_tpu_torch.kernels.prop_rollout import fused_rollout, pack_simple_cnn
from lns_tpu_torch.models import LatentDynamics, SimpleCNN
from lns_tpu_torch.utils.convert import propagator_state_dict, state_dict_from_jax

from _torch_port import load, perturb, small_ns2d_dict

STEPS, DECODE_CHUNK = 3, 4  # b * steps = 9 frames: the last chunk is padded


@pytest.fixture(scope="module")
def models():
    d = small_ns2d_dict()
    jmodel = JLatentDynamics(JConfig(d))
    init = jax.jit(lambda key: jmodel.init(key, (1, 32, 32, 1)))
    params = perturb(init(jax.random.PRNGKey(0))["params"], 4, 0.02)
    model = load(LatentDynamics(Config(d), device="cpu"), state_dict_from_jax(Config(d), params))
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 1)).astype(np.float32)
    return jmodel, params, model, x


@pytest.mark.parametrize("use_pallas", [True, False])
def test_predict_matches_jax(models, use_pallas):
    """JAX with its Pallas rollout (interpret mode) or its XLA scan, against
    the port with its kernels (their plain versions on the CPU) and with
    ``use_kernels(False)`` (the module step loop)."""
    jmodel, params, model, x = models
    ref = np.asarray(jmodel.predict({"params": params}, jnp.asarray(x), STEPS,
                                    decode_chunk=DECODE_CHUNK, use_pallas=use_pallas,
                                    pallas_interpret=True))
    assert ref.shape == (3, STEPS, 32, 32, 1)
    for flag in (True, False):
        out = model.use_kernels(flag).predict(torch.from_numpy(x), STEPS,
                                              decode_chunk=DECODE_CHUNK)
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-4, err_msg=f"kernels={flag}")
    model.use_kernels(True)


def test_predict_latents_and_unchunked_decode(models):
    jmodel, params, model, x = models
    zs_ref = np.asarray(jmodel.predict({"params": params}, jnp.asarray(x), STEPS,
                                       to_x=False, use_pallas=False))
    zs = model.predict(torch.from_numpy(x), STEPS, to_x=False)
    assert zs.shape == (3, STEPS, 4, 4, 16)
    np.testing.assert_allclose(zs.numpy(), zs_ref, atol=3e-4)
    y = model.predict(torch.from_numpy(x), STEPS)
    y_chunked = model.predict(torch.from_numpy(x), STEPS, decode_chunk=DECODE_CHUNK)
    np.testing.assert_allclose(y.numpy(), y_chunked.numpy(), atol=1e-5)


def test_bf16_propagator_step_matches_jax():
    cfg = Config(small_ns2d_dict())
    nb, c = cfg.prop_n_block, cfg.prop_n_embd
    jcnn = JSimpleCNN(16, nb, c, cfg.dilation, "circular", dtype=jnp.bfloat16)
    z = np.random.default_rng(6).standard_normal((2, 4, 4, 16)).astype(np.float32)
    params = perturb(jcnn.init(jax.random.PRNGKey(7), jnp.asarray(z))["params"], 7, 0.05)
    z16 = jnp.asarray(z).astype(jnp.bfloat16)
    ref = np.asarray(jcnn.apply({"params": params}, z16).astype(jnp.float32))

    cnn = load(SimpleCNN(16, nb, c, cfg.dilation, dtype=torch.bfloat16),
               propagator_state_dict(cfg, params))
    zt = torch.from_numpy(z).to(torch.bfloat16)
    with torch.no_grad():
        step = cnn(zt)
    rolled = fused_rollout(zt, pack_simple_cnn(cnn, torch.bfloat16), 1, nb, cfg.dilation,
                           "circular")[0]
    assert step.dtype == rolled.dtype == torch.bfloat16
    tol = 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(step.float().numpy(), ref, atol=tol)
    np.testing.assert_allclose(rolled.float().numpy(), ref, atol=tol)
