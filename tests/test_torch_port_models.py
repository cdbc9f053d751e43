"""The port's models (lns_tpu_torch.models) and checkpoint converter against
the JAX package, in f32 on the CPU.

Tolerances: the propagator step 2e-5 x max|z|, the rollout kernel's bound
(test_pallas_kernels.py:193), since one step is the same computation. The
autoencoder 3e-4, as tests/test_torch_export.py:48 holds the JAX AE to the
torch reference: some 30 conv / norm / attention layers of f32 rounding.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lns_tpu.config import Config as JConfig
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.models.propagator import SimpleCNN as JSimpleCNN
from lns_tpu.utils.torch_export import export_latent_dynamics
from lns_tpu_torch.config import Config, ns2d_config
from lns_tpu_torch.models import LatentDynamics, SimpleAutoencoder, SimpleCNN
from lns_tpu_torch.utils.convert import (propagator_state_dict, sequential_state_dict,
                                         state_dict_from_jax)

from _torch_port import load, perturb, small_ns2d_dict, to_np


def test_state_dict_from_jax_matches_export():
    """Key for key and value for value the state dict that the JAX
    package's exporter writes for the reference's strict load."""
    jcfg = JConfig(small_ns2d_dict())
    jmodel = JLatentDynamics(jcfg)
    params = to_np(jax.jit(lambda key: jmodel.init(key, (1, 32, 32, 1)))(jax.random.PRNGKey(0)))
    params = params["params"]
    ref = export_latent_dynamics(jcfg, params)
    ours = state_dict_from_jax(Config(small_ns2d_dict()), params)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    load(LatentDynamics(Config(small_ns2d_dict()), device="cpu"), ours)  # strict


@pytest.mark.parametrize("use_attn_enc", [False, True])
def test_full_size_keys_and_shapes_match(use_attn_enc):
    """At the NS2d widths the main paths run (with and without the encoder's
    attention blocks): the converter's keys and shapes are the port model's
    own (from the JAX init's shapes alone)."""
    jmodel = JLatentDynamics(graft._ns2d_cfg().replace(use_attn_enc=use_attn_enc))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), (1, 64, 64, 1)))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    cfg = ns2d_config().replace(use_attn_enc=use_attn_enc)
    state = state_dict_from_jax(cfg, params)
    own = LatentDynamics(cfg, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    assert any("encoder" in k and "low_rank_kernel" in k for k in own) == use_attn_enc


def test_latent_dynamics_builds_on_the_card_unless_told(monkeypatch):
    """With no device named the model is built on the CUDA card; where there
    is none that raises, naming ``device="cpu"``, which builds on the CPU."""
    cfg = Config(small_ns2d_dict())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LatentDynamics(cfg)
    model = LatentDynamics(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_simple_cnn_step_matches_jax():
    cfg = Config(small_ns2d_dict())
    jcnn = JSimpleCNN(16, cfg.prop_n_block, cfg.prop_n_embd, cfg.dilation, "circular")
    z = np.random.default_rng(0).standard_normal((2, 4, 4, 16)).astype(np.float32)
    params = perturb(jcnn.init(jax.random.PRNGKey(1), jnp.asarray(z))["params"], 1, 0.05)
    ref = np.asarray(jcnn.apply({"params": params}, jnp.asarray(z)))
    cnn = load(SimpleCNN(16, cfg.prop_n_block, cfg.prop_n_embd, cfg.dilation),
               propagator_state_dict(cfg, params))
    out = cnn(torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max())


def test_autoencoder_matches_jax():
    d = small_ns2d_dict()
    jae = JSimpleAutoencoder(JConfig(d))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    init = jax.jit(lambda key: jae.init(key, jnp.asarray(x)))
    params = perturb(init(jax.random.PRNGKey(3))["params"], 3, 0.02)
    z_ref = np.asarray(jae.apply({"params": params}, jnp.asarray(x), method="encode"))
    z = rng.standard_normal(z_ref.shape).astype(np.float32)
    y_ref = np.asarray(jae.apply({"params": params}, jnp.asarray(z), method="decode"))

    cfg = Config(d)
    state = {**sequential_state_dict(SimpleAutoencoder(cfg).encoder.specs,
                                     params["encoder"], "encoder.model"),
             **sequential_state_dict(SimpleAutoencoder(cfg).decoder.specs,
                                     params["decoder"], "decoder.model")}
    for name in ("quant_conv", "post_quant_conv"):
        state[f"{name}.weight"] = torch.tensor(params[name]["kernel"].T[:, :, None, None])
        state[f"{name}.bias"] = torch.tensor(params[name]["bias"])
    ae = load(SimpleAutoencoder(cfg), state)
    with torch.no_grad():
        np.testing.assert_allclose(ae.encode(torch.from_numpy(x)).numpy(), z_ref, atol=3e-4)
        np.testing.assert_allclose(ae.decode(torch.from_numpy(z)).numpy(), y_ref, atol=3e-4)


def test_import_leaves_jax_out():
    """The port imports torch and numpy only: nothing of JAX, flax, PyYAML
    or the JAX package, through any of its modules."""
    code = (
        "import importlib, pkgutil, sys, lns_tpu_torch\n"
        "for m in pkgutil.walk_packages(lns_tpu_torch.__path__, 'lns_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'yaml', 'lns_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'lns_tpu_torch.kernels.prop_rollout' in sys.modules\n"
        "assert 'lns_tpu_torch.data.shallow_water' in sys.modules\n"
        "assert 'lns_tpu_torch.data.zarr_reader' in sys.modules\n"
        "assert 'lns_tpu_torch.data.twophase' in sys.modules\n"
        "assert 'lns_tpu_torch.data.sloshing_solver' in sys.modules\n"
        "assert 'triton' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
