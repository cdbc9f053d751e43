"""The conditional two-phase family in the port against the JAX package, on
the CPU, at ``__graft_entry__._tiny_cond_cfg()`` (31x61x4 field, 7x15x16
latent, a 2 x 32 CondSimpleCNN with a 16-wide conditioning embedding)
unless a test says otherwise.

The same numpy inputs, made from seeds, go through ``lns_tpu`` and
``lns_tpu_torch``, with the JAX parameters converted by
``lns_tpu_torch.utils.convert``: the Fourier embedding, the conditional
block and propagator (f32, and bf16 against the jitted JAX modules), the
conditioning computed once per rollout, the zero-initialised gates, the
converter (also at ``twophase_conditional_config()``'s shapes),
``LatentDynamics.predict`` and ``rollout_loss`` with ``cond``, the
conditional dataset, both trainers side by side and the CLIs. Each
tolerance is stated where it is used; f32 holds 3e-4, the JAX package's own
bound for its models against the torch reference
(tests/test_torch_export.py).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lns_tpu.config import Config as JConfig
from lns_tpu.data import twophase as jtwophase
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.models.propagator import CondDilatedResidualBlock as JCondBlock
from lns_tpu.models.propagator import CondSimpleCNN as JCondSimpleCNN
from lns_tpu.ops.embedding import fourier_embedding as jfourier_embedding
from lns_tpu.train import Stage1Trainer as JStage1Trainer
from lns_tpu.train import Stage2Trainer as JStage2Trainer
from lns_tpu.train import stage1 as jstage1
from lns_tpu.train import stage2 as jstage2
from lns_tpu.train.logging_utils import MetricLogger as JMetricLogger
from lns_tpu.utils.torch_compat import convert_autoencoder, convert_latent_dynamics
from lns_tpu.utils.torch_export import (export_autoencoder, export_latent_dynamics,
                                        save_torch_checkpoint)
from lns_tpu_torch.config import Config, twophase_conditional_config
from lns_tpu_torch.data import epoch_batches, sloshing_solver, twophase
from lns_tpu_torch.models import CondSimpleCNN, LatentDynamics, SimpleAutoencoder
from lns_tpu_torch.models.autoencoder import CondEncoder
from lns_tpu_torch.models.propagator import CondDilatedResidualBlock
from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
from lns_tpu_torch.ops.embedding import fourier_embedding, fourier_freqs
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.ops.losses import smooth_l1_loss
from lns_tpu_torch.train import stage1, stage2
from lns_tpu_torch.utils.convert import propagator_state_dict, state_dict_from_jax

from _torch_port import load, nchw, nhwc, perturb, to_np


def _cfg_dict():
    return graft._tiny_cond_cfg().to_dict()


def _share(out, ref):
    return float((np.asarray(out) != np.asarray(ref)).mean())


def _bf16_ulp(x) -> float:
    """One bf16 ulp at the magnitude of max|x|."""
    m = float(np.abs(x).max())
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- the Fourier embedding -----------------------------------------------------------

@pytest.mark.parametrize("dim", [16, 64, 33])
def test_fourier_embedding_matches_jitted_jax(dim):
    """``fourier_freqs`` equal the frequencies of the jitted JAX function
    (XLA folds them as a constant), bitwise; ``fourier_embedding`` at 256
    values in [0, 1] has the jitted JAX function's shape (cos | sin,
    zero-padded at odd `dim`) and is within one f32 ulp of it (XLA's cos
    and sin are not torch's: measured 3.4-3.7 % of the elements one ulp
    apart, bound 5 %)."""
    half = dim // 2
    ref_f = np.asarray(jax.jit(lambda: jnp.exp(
        -math.log(10000) * jnp.arange(half, dtype=jnp.float32) / half))())
    assert np.array_equal(fourier_freqs(dim).numpy(), ref_f)
    t = np.random.default_rng(dim).uniform(0, 1, 256).astype(np.float32)
    ref = np.asarray(jax.jit(jfourier_embedding, static_argnums=1)(jnp.asarray(t), dim))
    out = fourier_embedding(torch.from_numpy(t), dim).numpy()
    assert out.shape == ref.shape == (256, dim)
    assert np.abs(out - ref).max() <= 2.0 ** -24 and _share(out, ref) <= 0.05
    if dim % 2:
        assert not out[:, -1].any()


# -- the conditional block and propagator ------------------------------------------------

def _block_pair(dtype, seed):
    """The JAX block (dim 32, embedding 16, dilation 2, zeros) with
    perturbed parameters and the port block loaded from them, on a
    [2, 7, 15, 32] input and a [2, 16] embedding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 7, 15, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    jb = JCondBlock(32, 16, dilation=2, padding_mode="zeros", dtype=dtype)
    p = perturb(jb.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(emb))["params"], seed)
    zeros = {"kernel": np.zeros((16, 16), np.float32), "bias": np.zeros(16, np.float32)}
    state = propagator_state_dict(Config(prop_n_block=1, cond_channels=1), {
        "in_proj": zeros, "cond_proj_fc1": zeros, "cond_proj_fc2": zeros, "net0": p,
        "out_gn": {"scale": zeros["bias"], "bias": zeros["bias"]}, "out_proj": zeros})
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else None
    m = load(CondDilatedResidualBlock(32, 16, 2, "zeros", tdt),
             {k[len("net.0."):]: v for k, v in state.items() if k.startswith("net.0.")})
    return jb, p, m, x, emb


# bf16 conditional block against the jitted JAX block, fed the same input and
# embedding: per seed the share of differing elements at most what was
# measured (0, 200 and 74 of 6,720). Its f32 GroupNorms, GELU and FiLM branch
# read the values the JAX block reads, rounded at the same points (seed 0: 0
# differ). At seeds 1 and 2 one element of conv1.1's bf16 output differs by a
# ulp (the library's f32 sum in another order, ROADMAP Queue 3 item 1), and
# the dilated conv after it, the f32 GroupNorm of the whole sample and the
# gated conv spread it: at most 9.2e-3 x max|ref| (2 bf16 ulps of max|ref|
# at seed 1), inside the repo's standing bf16 bound of 1e-2 x max|ref|
_BLOCK_BF16 = {0: 0.0, 1: 0.0298, 2: 0.0111}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cond_block_matches_jax(seed):
    """``CondDilatedResidualBlock`` in f32 within 3e-4 of the JAX block;
    in bf16 (its FiLM branch and the promoted sums in f32, as the JAX
    block's dtype rules give them) against the jitted JAX block with at
    most ``_BLOCK_BF16`` of the elements differing, within 1e-2 x
    max|ref|."""
    for dtype in (None, jnp.bfloat16):
        jb, p, m, x, emb = _block_pair(dtype, seed)
        xin = jnp.asarray(x, dtype or jnp.float32)
        ref = _f32(jax.jit(lambda p, x, e: jb.apply({"params": p}, x, e))(p, xin, jnp.asarray(emb)))
        with torch.no_grad():
            xt = nchw(x).to(torch.bfloat16 if dtype else torch.float32)
            out = nhwc(m(xt, m.conditioning(torch.from_numpy(emb))))
        assert out.shape == ref.shape
        if dtype is None:
            np.testing.assert_allclose(out, ref, atol=3e-4)
            continue
        err, share = np.abs(out - ref).max() / np.abs(ref).max(), _share(out, ref)
        assert err <= 1e-2 and share <= _BLOCK_BF16[seed], \
            f"bf16: {share:.4%} differ (<= {_BLOCK_BF16[seed]:.4%}), max_err {err:.2e} x max|ref|"


def _cnn_pair(dtype, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((3, 7, 15, 16)).astype(np.float32)
    param = rng.uniform(0, 1, 3).astype(np.float32)
    jm = JCondSimpleCNN(16, 16, 2, 32, 2, "zeros", dtype=dtype)
    p = perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(z), jnp.asarray(param))["params"],
                seed + 1)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else None
    m = load(CondSimpleCNN(16, 16, 2, 32, 2, "zeros", tdt),
             propagator_state_dict(Config(prop_n_block=2, cond_channels=1), p))
    return jm, p, m, z, param


# bf16 CondSimpleCNN, per part fed the jitted JAX network's own input to it:
# the share of differing elements at most what was measured (in_proj and the
# out_gn + out_proj tail bitwise; the blocks 10 and 36 of 10,080 elements,
# the f32 sums of their FiLM branch and GroupNorms taken in another order
# moving a value across a bf16 rounding boundary, then carried through a
# conv); and one whole step, where such a move shifts a later GroupNorm's
# rounded coefficients and with them whole channels (measured 20.0 %,
# within one bf16 ulp of max|ref|; ROADMAP Queue 3 item 1)
_CNN_BF16 = {"in_proj": 0.0, "net0": 0.0011, "net1": 0.0036, "out": 0.0, "step": 0.21}


def test_cond_simple_cnn_matches_jax():
    """``CondSimpleCNN`` one step in f32 within 3e-4 of the JAX module; in
    bf16 against the jitted JAX module: each part (in_proj, each block, the
    out_gn + out_proj tail) fed the JAX network's input to it (its captured
    intermediates) and the whole step, each with at most ``_CNN_BF16`` of
    its elements differing and within one bf16 ulp of max|ref|."""
    jm, p, m, z, param = _cnn_pair(None)
    ref = np.asarray(jax.jit(lambda p, z, q: jm.apply({"params": p}, z, q))(
        p, jnp.asarray(z), jnp.asarray(param)))
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(z), torch.from_numpy(param)).numpy(), ref,
                                   atol=3e-4)
    jm, p, m, z, param = _cnn_pair(jnp.bfloat16)
    ref, st = jax.jit(lambda p, z, q: jm.apply({"params": p}, z, q, capture_intermediates=True))(
        p, jnp.asarray(z, jnp.bfloat16), jnp.asarray(param))
    inter = {k: _f32(v["__call__"][0]) for k, v in st["intermediates"].items() if k != "__call__"}
    ref = _f32(ref)

    def bf(a):
        return nchw(a).to(torch.bfloat16)

    found = {}
    with torch.no_grad():
        emb = torch.from_numpy(inter["cond_proj_fc2"])
        found["in_proj"] = (nhwc(m.in_proj(bf(z))), inter["in_proj"])
        for i, block in enumerate(m.net):
            x = inter["in_proj" if i == 0 else f"net{i - 1}"]
            found[f"net{i}"] = (nhwc(block(bf(x), block.conditioning(emb))), inter[f"net{i}"])
        found["out"] = (nhwc(m.out_proj(bf(inter["net1"]))), ref)
        found["step"] = (m(torch.from_numpy(z).to(torch.bfloat16),
                           torch.from_numpy(param)).float().numpy(), ref)
    report = {k: f"{_share(o, r):.4%}" for k, (o, r) in found.items()}
    for k, (out, r) in found.items():
        assert out.shape == r.shape, k
        assert np.abs(out - r).max() <= _bf16_ulp(r) and _share(out, r) <= _CNN_BF16[k], \
            f"{k}: {report}"


def test_hoisted_conditioning_equals_the_per_step_form():
    """``conditioning`` once and ``step`` per step give the per-step form
    ``propagator(z, param)``'s rollout bitwise (f32 and bf16, 3 steps);
    ``rollout_loss`` (hoisted) and the per-step form's loss are bitwise
    equal, and every gradient, the sum over the steps that autograd forms
    once at the shared conditioning, within 1e-6 x max|g| (the same terms
    added in another order)."""
    cfg = Config(_cfg_dict())
    rng = np.random.default_rng(21)
    z_in = torch.from_numpy(rng.standard_normal((2, 1, 7, 15, 16)).astype(np.float32))
    z_out = torch.from_numpy(rng.standard_normal((2, 3, 7, 15, 16)).astype(np.float32))
    param = torch.from_numpy(rng.uniform(0, 1, 2).astype(np.float32))
    for dt in (None, torch.bfloat16):
        model = init_weights_(LatentDynamics(cfg, dtype=dt, device="cpu"),
                              torch.Generator().manual_seed(21))
        for m in model.modules():  # open the zero-initialised gates
            if getattr(m, "zero_init", False):
                m.weight.data.normal_(0, 0.05, generator=torch.Generator().manual_seed(22))
        prop = model.propagator
        with torch.no_grad():
            z = z_in[:, 0].to(dt or torch.float32)
            shared = prop.conditioning(param)
            a, b = z, z
            for _ in range(3):
                a, b = prop.step(a, shared), prop(b, param)
                assert torch.equal(a, b)
        grads = {}
        for form in ("hoisted", "per step"):
            model.zero_grad(set_to_none=True)
            if form == "hoisted":
                loss = model.rollout_loss(z_in, z_out, param)
            else:
                z, preds = z_in[:, 0].to(dt or torch.float32), []
                for _ in range(3):
                    z = prop(z, param)
                    preds.append(z)
                loss = smooth_l1_loss(torch.stack(preds, 1).float(), z_out)
            loss.backward()
            grads[form] = (loss.detach(), {k: q.grad.clone() for k, q in prop.named_parameters()})
        assert torch.equal(grads["hoisted"][0], grads["per step"][0])
        for k, g in grads["hoisted"][1].items():
            r = grads["per step"][1][k]
            assert r.abs().max() > 0, k
            torch.testing.assert_close(g, r, rtol=0, atol=1e-6 * r.abs().max().item(), msg=k)


def test_init_weights_leaves_the_gates_at_zero():
    """``init_weights_`` fills every conv and linear parameter of the
    conditional propagator from the generator but the two gates of each block (``cond_conv1.2`` and
    ``cond_conv2.3``, weights and biases), which stay at zero, the
    reference's ``zero_module`` start: the block then adds nothing through
    its gated conv and scales its FFN input by 1."""
    model = init_weights_(LatentDynamics(Config(_cfg_dict()), device="cpu"),
                          torch.Generator().manual_seed(3))
    gates = {f"propagator.net.{i}.{g}" for i in range(2) for g in ("cond_conv1.2", "cond_conv2.3")}
    layers = {f"propagator.{k}": m for k, m in model.propagator.named_modules()
              if isinstance(m, (ConvND, Conv1x1, Dense))}
    assert gates <= layers.keys()
    for k, m in layers.items():
        for name, v in m.named_parameters():
            assert bool(v.any()) == (k not in gates), f"{k}.{name}"
    block = model.propagator.net[0]
    with torch.no_grad():
        e, c = block.conditioning(torch.randn(2, 16))
        assert not c.any()


# -- the converter and the model at full width -----------------------------------------

@pytest.fixture(scope="module")
def cond_params():
    """The JAX conditional model's parameters, numpy leaves: the port's
    seeded init (gates at zero) through ``torch_compat``, with seeded noise
    on every leaf (so the gates are open)."""
    model = init_weights_(LatentDynamics(Config(_cfg_dict()), device="cpu"),
                          torch.Generator().manual_seed(7))
    return perturb(convert_latent_dynamics(
        JConfig(_cfg_dict()), {k: v.numpy() for k, v in model.state_dict().items()}), 7, 0.02)


def test_conditional_state_dict_from_jax_matches_export(cond_params):
    """Key for key and value for value the state dict that the JAX
    package's exporter writes for the conditional model (the autoencoder
    under ``ae.``), loaded strictly."""
    ref = export_latent_dynamics(JConfig(_cfg_dict()), cond_params)
    ours = state_dict_from_jax(Config(_cfg_dict()), {"params": cond_params})
    assert sorted(ours) == sorted(ref)
    assert any(k.startswith("ae.") for k in ours) and not any(k.startswith("vq_ae.") for k in ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    load(LatentDynamics(Config(_cfg_dict()), device="cpu"), ours)  # strict


def test_conditional_full_size_keys_shapes_and_predict():
    """At ``twophase_conditional_config()``'s full widths (its embedding 64
    wide, ``latent_dim``) the converter's keys and shapes are the port
    model's own (from the JAX init's shapes alone), the state dict loads
    strictly, and ``LatentDynamics`` built on the CPU predicts finite
    fields of the right shape (batch 1, 1 step, a parameter in [0, 1])."""
    cfg = twophase_conditional_config()
    assert cfg.workload == "twophase_conditional" and cfg.cond_emb_channels == 64
    jmodel = JLatentDynamics(JConfig(cfg.to_dict()))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), (1, 61, 121, 4)))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    state = state_dict_from_jax(cfg, params)
    model = LatentDynamics(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert tuple(state["propagator.cond_emb_proj.0.weight"].shape) == (64, 64)
    load(model, state)  # strict
    init_weights_(model, torch.Generator().manual_seed(8))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 61, 121, 4))
                         .astype(np.float32))
    y = model.predict(x, 1, torch.tensor([0.4]))
    assert y.shape == (1, 1, 61, 121, 4) and torch.isfinite(y).all()
    assert isinstance(model.propagator, CondSimpleCNN) and model.propagator.padding_mode == "zeros"


# -- predict and the rollout loss ------------------------------------------------------------

def _param(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, n).astype(np.float32)


def test_conditional_predict_matches_jax(cond_params):
    """``LatentDynamics.predict`` with ``cond`` (3 steps, f32) within 3e-4
    of the JAX ``predict``, the port's kernels on and off (their plain
    versions here; the conditional propagator steps as modules either
    way); a different ``cond`` gives a different prediction."""
    d = _cfg_dict()
    jm = JLatentDynamics(JConfig(d))
    model = load(LatentDynamics(Config(d), device="cpu"),
                 state_dict_from_jax(Config(d), cond_params))
    x = np.random.default_rng(7).standard_normal((2, 31, 61, 4)).astype(np.float32)
    cond = _param(2, 7)
    ref = np.asarray(jax.jit(lambda p, x, c: jm.predict(p, x, 3, cond=c))(
        cond_params, jnp.asarray(x), jnp.asarray(cond)))
    for flag in (True, False):
        out = model.use_kernels(flag).predict(torch.from_numpy(x), 3, torch.from_numpy(cond))
        assert out.shape == (2, 3, 31, 61, 4)
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-4, err_msg=f"kernels {flag}")
    other = model.predict(torch.from_numpy(x), 3, torch.from_numpy(cond[::-1].copy()))
    assert (other - torch.from_numpy(ref)).abs().max() > 1e-2


# bf16, each rollout step from the JAX rollout's own carry (the JAX scan's
# steps equal its jitted step's, bitwise): the share of differing elements at
# most what was measured (1.19, 35.36 and 23.39 % of 6,720 at steps 0-2),
# within 1e-2 x max|ref| (measured 3.0e-3 to 5.9e-3). Fed the JAX network's
# own input, each part of the step differs in at most 0.36 %
# (test_cond_simple_cnn_matches_jax); chained, a value one ulp apart moves
# the f32 statistics of the next bf16 GroupNorm(1), and with them the bf16
# rounding of its per-channel scale, so whole channels move by an ulp
# (ROADMAP Queue 3 item 1)
_STEP_BF16 = 0.36


def test_conditional_predict_bf16_step_by_step(cond_params):
    """The bf16 model (f32 parameters, bf16 activations): every step of the
    JAX package's jitted bf16 rollout (``predict_latents``, its scan)
    computed by the port from the JAX step's own carry, with the
    conditioning computed once, within 1e-2 x max|ref| and at most
    ``_STEP_BF16`` of the elements differing; the port's bf16 ``predict``
    with ``cond`` decodes finite fields."""
    d = _cfg_dict()
    jm = JLatentDynamics(JConfig(d), dtype=jnp.bfloat16, ae_dtype=jnp.bfloat16)
    model = load(LatentDynamics(Config(d), dtype=torch.bfloat16, ae_dtype=torch.bfloat16,
                                device="cpu"), state_dict_from_jax(Config(d), cond_params))
    x = np.random.default_rng(9).standard_normal((2, 31, 61, 4)).astype(np.float32)
    cond = _param(2, 9)
    z0 = jax.jit(lambda p, x: jm.encode(p, x).astype(jnp.bfloat16))(cond_params, jnp.asarray(x))
    zs = _f32(jax.jit(lambda p, x, c: jm.predict_latents(p, x, 3, c))(
        cond_params, jnp.asarray(x), jnp.asarray(cond)))
    carries = [_f32(z0)] + [zs[:, t] for t in range(2)]
    with torch.no_grad():
        shared = model.conditioning(torch.from_numpy(cond))
        for t, carry in enumerate(carries):
            out = model._step(torch.from_numpy(carry).to(torch.bfloat16), shared).float().numpy()
            ref = zs[:, t]
            err, share = np.abs(out - ref).max() / np.abs(ref).max(), _share(out, ref)
            assert err <= 1e-2 and share <= _STEP_BF16, \
                f"step {t}: {share:.4%} differ, max_err {err:.2e} x max|ref|"
        y = model.predict(torch.from_numpy(x), 3, torch.from_numpy(cond))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, 31, 61, 4) and torch.isfinite(y).all()


@pytest.mark.parametrize("remat", [False, True])
def test_conditional_rollout_loss_and_gradients_match_jax(cond_params, remat):
    """``rollout_loss`` with ``cond`` (out_tw 3) within rel 1e-5 of the JAX
    loss, and every propagator gradient within 1e-4 x max|g| of
    ``jax.value_and_grad``'s (f32, sums in another order), the JAX
    gradients mapped to the port's names by ``propagator_state_dict``."""
    d = _cfg_dict()
    jm = JLatentDynamics(JConfig(d))
    model = load(LatentDynamics(Config(d), device="cpu"),
                 state_dict_from_jax(Config(d), cond_params))
    rng = np.random.default_rng(23)
    z_in = rng.standard_normal((3, 1, 7, 15, 16)).astype(np.float32)
    z_out = rng.standard_normal((3, 3, 7, 15, 16)).astype(np.float32)
    cond = _param(3, 23)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda pp: jm.rollout_loss({"propagator": pp}, jnp.asarray(z_in), jnp.asarray(z_out),
                                   jnp.asarray(cond), remat=remat)))(
        jax.tree.map(jnp.asarray, cond_params["propagator"]))
    ref = propagator_state_dict(model.cfg, to_np(grads_j))
    model.zero_grad(set_to_none=True)
    loss = model.rollout_loss(torch.from_numpy(z_in), torch.from_numpy(z_out),
                              torch.from_numpy(cond), remat=remat)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    grads = {k: q.grad for k, q in model.propagator.named_parameters()}
    assert grads.keys() == ref.keys()
    for k, g in grads.items():
        scale = ref[k].abs().max().item()
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=1e-4 * scale, err_msg=k)


def test_unported_and_misplaced_conditioning_raise():
    """``CondEncoder`` (the parameter-conditioned encoder, ported with the
    library blocks) builds and encodes to the latent grid (its parity with
    the JAX package: tests/test_torch_port_library.py). A model that is not
    conditional refuses ``cond``; a conditional one refuses to step without
    it."""
    enc = CondEncoder(Config(_cfg_dict()))
    with torch.no_grad():
        h = enc(torch.zeros(1, 4, 31, 61), torch.tensor([0.5]))
    assert tuple(h.shape) == (1, 16, 7, 15) and torch.isfinite(h).all()
    d = _cfg_dict()
    del d["cond_channels"], d["cond_emb_channels"]
    plain = LatentDynamics(Config(d), device="cpu")
    cond_model = LatentDynamics(Config(_cfg_dict()), device="cpu")
    x = torch.zeros(1, 31, 61, 4)
    z = torch.zeros(1, 1, 7, 15, 16)
    with pytest.raises(ValueError, match="not conditional"):
        plain.predict(x, 1, torch.zeros(1))
    with pytest.raises(ValueError, match="not conditional"):
        plain.rollout_loss(z, z, torch.zeros(1))
    with pytest.raises(ValueError, match="pass cond"):
        cond_model.predict(x, 1)
    with pytest.raises(ValueError, match="pass cond"):
        cond_model.rollout_loss(z, z)


# -- the dataset --------------------------------------------------------------------

def test_conditional_dataset_matches_jax(tmp_path):
    """On a ``make_sloshing_dir(vary="freq")`` corpus (64 rows, clipped to
    61), ``ConditionalTankSloshingStage2`` (with the window quirk and
    without, train and test splits) equals the JAX dataset bitwise: its
    raw parameters, the stats (the parameter range widened by 2), its
    batches (z_in, z_out, the normalised parameter) after the same encode
    and ``eval_trajectories`` (x0, y, parameter); a stats file that a
    stage-1 run wrote (no range) is read and the range added as the JAX
    dataset adds it, the file left as it was."""
    data = sloshing_solver.make_sloshing_dir(str(tmp_path / "d"), ncase=10, case_len=7, h=64,
                                             w=20, seed=4, vary="freq")
    d = dict(data_dir=data, dataset_stat=str(tmp_path / "stat.npz"), case_len=7, num_case=10,
             in_tw=1, out_tw=2)
    ks = (1.0, -2.0)
    for quirk in (False, True):
        for train_mode in (True, False):
            j = jtwophase.ConditionalTankSloshingStage2(JConfig(d, window_quirk=quirk), train_mode)
            p = twophase.ConditionalTankSloshingStage2(Config(d, window_quirk=quirk), train_mode)
            assert len(j) == len(p) and p.fields.shape[2] == 61
            assert p.params_raw.dtype == j.params_raw.dtype
            assert np.array_equal(p.params_raw, j.params_raw)
            assert p.stats.keys() == j.stats.keys() and {"param_min", "param_max"} <= p.stats.keys()
            assert all(np.array_equal(p.stats[k], j.stats[k]) for k in p.stats)
            for a, b in zip(p.eval_trajectories(), j.eval_trajectories()):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            j.encode_dataset(lambda x: np.concatenate([x[:, ::4, ::4] * k for k in ks], -1),
                             batch=4)
            p.encode_dataset(lambda x: torch.cat([x[:, ::4, ::4] * k for k in ks], -1), "cpu",
                             batch=4)
            idx = np.random.default_rng(11).permutation(len(j))
            batch = p.get_batch(idx)
            assert len(batch) == 3 and batch[2].shape == (len(j),)
            for a, b in zip(batch, j.get_batch(idx)):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    # a stage-1 stats file (no parameter range)
    s1 = str(tmp_path / "stat_s1.npz")
    twophase.TankSloshingStage1(Config(d, dataset_stat=s1), True)
    j = jtwophase.ConditionalTankSloshingStage2(JConfig(d, dataset_stat=s1), True)
    p = twophase.ConditionalTankSloshingStage2(Config(d, dataset_stat=s1), True)
    assert all(np.array_equal(p.stats[k], j.stats[k]) for k in p.stats)
    assert np.array_equal(p.normalize_param(p.params_raw), j.normalize_param(j.params_raw))
    with np.load(s1, allow_pickle=True) as f:
        assert "param_min" not in f.files


# -- the trainers side by side and the CLIs ---------------------------------------------

def _data_cfg(tmp, **over):
    """The test-size conditional model on a ``make_sloshing_dir(vary=
    "freq")`` corpus of 10 cases x 6 frames of 31x61 (9 training cases, 1
    test case): stage 1 takes 54 frames (7 steps of batch 8, the last of
    6), stage 2 27 windows (out_tw 2; 3 steps of batch 8) and a validation
    rollout of 5 steps."""
    os.makedirs(tmp, exist_ok=True)
    data = os.path.join(tmp, "freq")
    if not os.path.exists(data):
        sloshing_solver.make_sloshing_dir(data, ncase=10, case_len=6, h=31, w=61, seed=11,
                                          vary="freq")
    d = _cfg_dict()
    d.update(data_dir=data, dataset_stat=os.path.join(tmp, "stat.npz"), case_len=6,
             num_case=10, batch_size=8, epochs=1, learning_rate=5e-4, beta1=0.5, beta2=0.9,
             ckpt_every=1, log_dir=os.path.join(tmp, "log"), overwrite_exist=True)
    d.update(over)
    return d


def _metrics(log_dir, key):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _check_validation(jt, pt, keys, tmp):
    """The port trainer's first validation (before any step) against the
    JAX trainer's ``validate`` at the same weights: each key within rel
    1e-4 (f32, sums in another order)."""
    os.makedirs(tmp, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jstage1, jstage2):
            mp.setattr(mod, "log_sequence", lambda *a: None)
            mp.setattr(mod, "plot_error_curve", lambda *a: None)
        jt.logger = JMetricLogger(tmp, use_wandb=False)
        jt.validate(0)
        jt.logger.finish()
    for key in keys:
        jv, pv = _metrics(tmp, key), _metrics(pt.cfg.log_dir, key)
        assert len(jv) == 1 and len(pv) == 2, key
        np.testing.assert_allclose(pv[0], jv[0], rtol=1e-4, err_msg=key)


_NAMES = ("vx", "vy", "prs", "vof")


def test_conditional_stage1_trainer_matches_jax(tmp_path):
    """One epoch of the port's stage-1 trainer on the conditional config (7
    steps, f32) from the JAX trainer's parameters: the plain two-phase
    autoencoder, finite losses; the first step's loss (on denormalised
    fields, as for the two-phase family) within rel 1e-4 of the JAX
    trainer's on the same batch and weights; the first validation's
    ``val_recon_loss`` and per-channel losses within rel 1e-4."""
    d = _data_cfg(str(tmp_path))
    jcfg = JConfig(d)
    ae = init_weights_(SimpleAutoencoder(Config(d)), torch.Generator().manual_seed(12))
    params = perturb(convert_autoencoder(jcfg, {k: v.numpy() for k, v in ae.state_dict().items()}),
                     12, 0.02)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSimpleAutoencoder, "init", lambda self, key, x: {"params": params})
        jt = JStage1Trainer(JConfig(d, log_dir=os.path.join(tmp_path, "jlog")), seed=5,
                            use_wandb=False)
    pt = stage1.Stage1Trainer(Config(d, log_dir=os.path.join(tmp_path, "plog")), seed=5,
                              use_wandb=False, device="cpu")
    assert isinstance(pt.model, SimpleAutoencoder) and pt._loss_denorm is not None
    pt.model.load_state_dict(_tensors(export_autoencoder(jcfg, params)), strict=True)
    first = next(epoch_batches(len(jt.train_ds), d["batch_size"], np.random.default_rng([5, 0]),
                               drop_last=False))
    x = jt.train_ds.get_batch(first)
    jloss = float(jax.jit(jt._loss)(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    pt.train()
    pl = _metrics(pt.cfg.log_dir, "rec_loss")
    assert len(pl) == 7 and np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl[0], jloss, rtol=1e-4)
    _check_validation(jt, pt, ("val_recon_loss",) + tuple(f"val_recon_loss_{n}" for n in _NAMES),
                      str(tmp_path / "jval"))


def test_conditional_stage2_trainer_matches_jax(tmp_path):
    """One epoch of the port's conditional stage-2 trainer (3 steps, f32,
    noise 0, the windows on the device), both trainers loading one stage-1
    ``.pt`` that ``torch_export`` wrote into the autoencoder (``ae``), from
    the same propagator parameters: the encode pre-pass within 3e-4 of the
    JAX trainer's; the first batch's parameters bitwise; finite losses, the
    first step's loss within rel 1e-4 of the JAX ``rollout_loss`` with
    ``cond``; the first validation (each case's parameter) within rel 1e-4;
    ``model_final.pt`` with ``ae.`` keys, which a resumed trainer loads
    bitwise."""
    d = _data_cfg(str(tmp_path), out_tw=2, noise_level=0.0, device_data=True)
    jcfg = JConfig(d)
    sd = init_weights_(LatentDynamics(Config(d), device="cpu"), torch.Generator().manual_seed(13))
    params = perturb(convert_latent_dynamics(jcfg, {k: v.numpy() for k, v in
                                                    sd.state_dict().items()}), 13, 0.02)
    ae_path = os.path.join(tmp_path, "ae.pt")
    save_torch_checkpoint(export_autoencoder(jcfg, params["vq_ae"]), ae_path)
    d.update(pretrained_checkpoint_path=ae_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLatentDynamics, "init", lambda self, key, shape: {"params": params})
        jt = JStage2Trainer(JConfig(d, log_dir=os.path.join(tmp_path, "jlog")), seed=5,
                            use_wandb=False)
    pt = stage2.Stage2Trainer(Config(d, log_dir=os.path.join(tmp_path, "plog")), seed=5,
                              use_wandb=False, device="cpu")
    np.testing.assert_allclose(pt.train_ds.encoded, np.asarray(jt.train_ds.encoded, np.float32),
                               atol=3e-4)
    pt.model.load_state_dict(state_dict_from_jax(pt.cfg, to_np(jt.params)), strict=True)
    first = next(epoch_batches(len(pt.train_ds), 8, np.random.default_rng([5, 0]),
                               drop_last=True))
    z_in, z_out, cond = pt.train_ds.get_batch(first)
    assert np.array_equal(cond, jt.train_ds.get_batch(first)[2])
    jloss = float(jax.jit(jt.model.rollout_loss)(jt.params, jnp.asarray(z_in),
                                                 jnp.asarray(z_out), jnp.asarray(cond)))
    pt.train()
    pl = _metrics(pt.cfg.log_dir, "loss")
    assert len(pl) == 3 and np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl[0], jloss, rtol=1e-4)
    _check_validation(jt, pt, ("val_seq_rel_l2",) + tuple(f"val_pred_loss_{n}" for n in _NAMES),
                      str(tmp_path / "jval"))
    final = os.path.join(pt.cfg.log_dir, "checkpoints", "model_final.pt")
    saved = torch.load(final, weights_only=True)
    assert any(k.startswith("ae.") for k in saved) and not any(k.startswith("vq_ae.")
                                                                 for k in saved)
    resumed = stage2.Stage2Trainer(Config(d, log_dir=os.path.join(tmp_path, "rlog"),
                                          resume_training=True, resume_ckpt=final),
                                   seed=5, use_wandb=False, device="cpu")
    assert resumed.start_epoch == 1
    assert all(torch.equal(v, saved[k]) for k, v in resumed.model.state_dict().items())


def test_conditional_clis_train_on_the_cpu(tmp_path):
    """``python -m lns_tpu_torch.cli.train_stage1`` and ``train_stage2``
    with a conditional YAML (``cond_channels`` set), ``--device cpu
    --no-wandb``: one epoch each, the second on the first's final
    checkpoint; both write their metrics and final checkpoints."""
    import yaml

    from lns_tpu_torch.cli import train_stage1, train_stage2

    d1 = _data_cfg(str(tmp_path), ckpt_every=9, log_dir=str(tmp_path / "s1"))
    assert d1["cond_channels"] == 1
    (tmp_path / "s1.yml").write_text(yaml.safe_dump(d1))
    train_stage1.main(["--config", str(tmp_path / "s1.yml"), "--device", "cpu", "--no-wandb"])
    ae = tmp_path / "s1" / "checkpoints" / "vqgan_epoch_final.pt"
    assert ae.exists() and _metrics(d1["log_dir"], "rec_loss")
    d2 = _data_cfg(str(tmp_path), ckpt_every=9, log_dir=str(tmp_path / "s2"),
                   pretrained_checkpoint_path=str(ae))
    (tmp_path / "s2.yml").write_text(yaml.safe_dump(d2))
    train_stage2.main(["--config", str(tmp_path / "s2.yml"), "--device", "cpu", "--no-wandb"])
    assert (tmp_path / "s2" / "checkpoints" / "model_final.pt").exists()
    assert _metrics(d2["log_dir"], "loss")
