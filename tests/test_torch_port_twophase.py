"""The two-phase (tank sloshing) family in the port against the JAX package,
on the CPU, at ``__graft_entry__._tiny_cond_cfg()`` without its ``cond_*``
keys (31x61x4 field, 7x15x16 latent, zero padding) unless a test says
otherwise.

The same numpy inputs, made from seeds, go through ``lns_tpu`` and
``lns_tpu_torch``, with the JAX parameters converted by
``lns_tpu_torch.utils.convert``: the zero-padded convs and downsamples at odd
sides (f32, and bf16 against the jitted JAX modules), the zero-padded
blocks, the non-squared autoencoder (f32, and bf16 layer by layer), the
converter (also at ``twophase_config()``'s shapes), the zeros-mode
propagator and the fused rollout's plain version, ``LatentDynamics.predict``,
``gradient_domain_loss``, the sloshing and synthetic corpora and the
two-phase datasets, both trainers side by side and the CLIs. Each tolerance
is stated where it is used; f32 holds 3e-4, the JAX package's own bound for
its AE against the torch reference (tests/test_torch_export.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lns_tpu.config import Config as JConfig
from lns_tpu.data import sloshing_solver as jsloshing
from lns_tpu.data import synthetic as jsynthetic
from lns_tpu.data import twophase as jtwophase
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.models.autoencoder import resize_nearest_torch
from lns_tpu.models.propagator import SimpleCNN as JSimpleCNN
from lns_tpu.ops import resblocks as jres
from lns_tpu.ops.activations import swish as jswish
from lns_tpu.ops.conv import ConvND as JConvND
from lns_tpu.ops.losses import gradient_domain_loss as jgradient_domain_loss
from lns_tpu.pallas_kernels import prop_rollout as jpr
from lns_tpu.train import Stage1Trainer as JStage1Trainer
from lns_tpu.train import Stage2Trainer as JStage2Trainer
from lns_tpu.train import stage1 as jstage1
from lns_tpu.train import stage2 as jstage2
from lns_tpu.train.logging_utils import MetricLogger as JMetricLogger
from lns_tpu.utils.torch_compat import convert_autoencoder, convert_latent_dynamics
from lns_tpu.utils.torch_export import (export_autoencoder, export_latent_dynamics,
                                        save_torch_checkpoint)
from lns_tpu_torch.config import Config, twophase_config
from lns_tpu_torch.data import epoch_batches, sloshing_solver, synthetic, twophase
from lns_tpu_torch.kernels import prop_rollout
from lns_tpu_torch.models import LatentDynamics, SimpleAutoencoder, SimpleCNN
from lns_tpu_torch.models.autoencoder import Resize
from lns_tpu_torch.models.specs import LayerSpec
from lns_tpu_torch.ops import conv, resblocks
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.ops.losses import gradient_domain_loss
from lns_tpu_torch.train import stage1, stage2
from lns_tpu_torch.utils.convert import (propagator_state_dict, sequential_state_dict,
                                         state_dict_from_jax)

from _torch_port import load, nchw, nhwc, perturb, to_np


def _tp_dict():
    d = graft._tiny_cond_cfg().to_dict()
    del d["cond_channels"], d["cond_emb_channels"]
    return d


def _share(out, ref):
    return float((np.asarray(out) != np.asarray(ref)).mean())


def _conv_state(p):
    return {"weight": torch.from_numpy(np.asarray(p["kernel"])).permute(3, 2, 0, 1),
            "bias": torch.from_numpy(np.asarray(p["bias"]))}


# -- the zero-padded convs at odd sides -------------------------------------------

# (field, stride, padding, dilation, upsample_2x) of every zero-padded conv the
# two-phase models run at odd sides: the 3x3 conv at the field, the encoder's
# stride-2 downsample (its (0, 1) pad: 31 -> 15 -> 7, 61 -> 30 -> 15), the
# upsampling conv from the latent and the propagator's dilated conv
_ZERO_CONVS = {"3x3": ((31, 61), 1, 1, 1, False), "down 31x61": ((31, 61), 2, 0, 1, False),
               "down 15x30": ((15, 30), 2, 0, 1, False), "up 7x15": ((7, 15), 1, 1, 1, True),
               "dilated 7x15": ((7, 15), 1, 2, 2, False)}

# bf16 against the jitted JAX conv, at c 32 -> 32, batch 2: the share of
# differing elements, at most what was measured (3x3 4 of 121,024 elements,
# the 31x61 downsample 1 of 28,800, the upsampling conv 1 of 26,880, the
# others none: the library's sum order, ROADMAP Queue 3 item 1), each within
# 2.1e-3 x max|ref|
_ZERO_BF16 = {"3x3": 3.4e-5, "down 31x61": 3.5e-5, "down 15x30": 0.0, "up 7x15": 3.8e-5,
              "dilated 7x15": 0.0}


def _zero_conv_pair(kind, x, dtype=None, seed=0):
    _, stride, pad, dil, up = _ZERO_CONVS[kind]
    if kind.startswith("down"):  # the DownSampleBlock's asymmetric pad
        jm, m = (jres.DownSampleBlock(32, 2, padding_mode="zeros", dtype=dtype),
                 resblocks.DownSampleBlock(32, "zeros"))
        p = perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)
        return jm, p, load(m, {f"conv_layer.{k}": v for k, v in _conv_state(p["conv"]).items()})
    jm = JConvND(32, 3, stride=stride, padding=pad, dilation=dil, padding_mode="zeros",
                 upsample_2x=up, dtype=dtype)
    p = perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)
    m = conv.ConvND(32, 32, 3, stride=stride, padding=pad, dilation=dil, padding_mode="zeros",
                    upsample_2x=up)
    return jm, p, load(m, _conv_state(p))


@pytest.mark.parametrize("kind", list(_ZERO_CONVS))
def test_zero_padded_conv_matches_jax(kind):
    """Each zero-padded conv at odd sides in f32 within 3e-4 of the JAX
    module, and in bf16 against the jitted JAX module with at most
    ``_ZERO_BF16`` of the elements differing, within 1e-2 x max|ref|."""
    hw = _ZERO_CONVS[kind][0]
    x = np.random.default_rng(1).standard_normal((2, *hw, 32)).astype(np.float32)
    jm, p, m = _zero_conv_pair(kind, x)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        out = nhwc(m(nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=3e-4)
    jm, p, m = _zero_conv_pair(kind, x, dtype=jnp.bfloat16)
    for mod in m.modules():
        if isinstance(mod, conv.ConvND):
            mod.dtype = torch.bfloat16
    ref = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        p, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        out = nhwc(m(nchw(x).to(torch.bfloat16)))
    err, share = np.abs(out - ref).max() / np.abs(ref).max(), _share(out, ref)
    assert err <= 1e-2 and share <= _ZERO_BF16[kind], \
        f"bf16: {share:.4%} differ (<= {_ZERO_BF16[kind]:.4%}), max_err {err:.2e} x max|ref|"


def test_resize_matches_jax():
    """The decoder's nearest resize from 14x30 to 31x61 (and 28x60 to
    61x121, the full model's) is ``resize_nearest_torch``, bitwise."""
    for (h, w), (oh, ow) in (((14, 30), (31, 61)), ((28, 60), (61, 121))):
        x = np.random.default_rng(2).standard_normal((2, h, w, 8)).astype(np.float32)
        ref = np.asarray(resize_nearest_torch(jnp.asarray(x), oh, ow))
        out = nhwc(Resize(oh, ow)(nchw(x)))
        assert out.shape == ref.shape and np.array_equal(out, ref)


# -- the zero-padded blocks and the non-squared autoencoder ----------------------------

_BLOCKS = {
    "resblock": lambda: (jres.ResidualBlock(32, 32, 2, padding_mode="zeros"),
                         resblocks.ResidualBlock(32, 32, "zeros"), "resblock"),
    "resblock_channel_up": lambda: (jres.ResidualBlock(32, 64, 2, padding_mode="zeros"),
                                    resblocks.ResidualBlock(32, 64, "zeros"), "resblock"),
    "down": lambda: (jres.DownSampleBlock(32, 2, padding_mode="zeros"),
                     resblocks.DownSampleBlock(32, "zeros"), "down"),
    "up": lambda: (jres.UpSampleBlock(32, 2, padding_mode="zeros"),
                   resblocks.UpSampleBlock(32, "zeros"), "up"),
}


@pytest.mark.parametrize("name", list(_BLOCKS))
def test_zero_padded_blocks_match_jax(name):
    """``ResidualBlock`` (with and without ``channel_up``), the
    downsample and the upsample block in zeros mode at 15x31, in f32 within
    3e-4, on the weights the converter carries over."""
    jm, m, kind = _BLOCKS[name]()
    x = np.random.default_rng(3).standard_normal((2, 15, 31, 32)).astype(np.float32)
    p = perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 3)
    kw = ({"in_channels": 32, "out_channels": 64 if "channel_up" in name else 32,
           "padding_mode": "zeros"} if kind == "resblock"
          else {"channels": 32, "padding_mode": "zeros"})
    spec = LayerSpec(0, kind, tuple(sorted(kw.items())))
    state = sequential_state_dict([spec], {spec.name: p}, "m")
    load(m, {k[len("m.0."):]: v for k, v in state.items()})
    ref = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, jnp.asarray(x)))
    with torch.no_grad():
        out = nhwc(m(nchw(x)))
    np.testing.assert_allclose(out, ref, atol=3e-4)


@pytest.fixture(scope="module")
def tp_params():
    """The JAX two-phase model's parameters, numpy leaves: the port's
    seeded init through ``torch_compat`` (faster here than the JAX
    package's own init), with seeded noise on every leaf."""
    model = init_weights_(LatentDynamics(Config(_tp_dict()), device="cpu"),
                          torch.Generator().manual_seed(7))
    return perturb(convert_latent_dynamics(
        JConfig(_tp_dict()), {k: v.numpy() for k, v in model.state_dict().items()}), 7, 0.02)


def _ae_pair(tp_params, dtype=None, seed=3):
    d = _tp_dict()
    jae = JSimpleAutoencoder(JConfig(d), dtype=dtype)
    x = np.random.default_rng(seed).standard_normal((2, 31, 61, 4)).astype(np.float32)
    params = tp_params["vq_ae"]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else None
    ae = SimpleAutoencoder(Config(d), dtype=tdt)
    state = {**sequential_state_dict(ae.encoder.specs, params["encoder"], "encoder.model"),
             **sequential_state_dict(ae.decoder.specs, params["decoder"], "decoder.model")}
    for name in ("quant_conv", "post_quant_conv"):
        state[f"{name}.weight"] = torch.tensor(params[name]["kernel"].T[:, :, None, None])
        state[f"{name}.bias"] = torch.tensor(params[name]["bias"])
    return jae, params, load(ae, state), x


def test_twophase_autoencoder_matches_jax(tp_params):
    """The non-squared AE's encode (31x61 -> 7x15) and decode (through the
    14x30 -> 31x61 resize) in f32 within 3e-4 of the JAX AE."""
    jae, params, ae, x = _ae_pair(tp_params)
    run = jax.jit(lambda p, x, method: jae.apply({"params": p}, x, method=method),
                  static_argnums=2)
    z_ref = np.asarray(run(params, jnp.asarray(x), "encode"))
    assert z_ref.shape == (2, 7, 15, 16)
    z = np.random.default_rng(4).standard_normal(z_ref.shape).astype(np.float32)
    y_ref = np.asarray(run(params, jnp.asarray(z), "decode"))
    with torch.no_grad():
        np.testing.assert_allclose(ae.encode(torch.from_numpy(x)).numpy(), z_ref, atol=3e-4)
        np.testing.assert_allclose(ae.decode(torch.from_numpy(z)).numpy(), y_ref, atol=3e-4)


# Per layer kind of the bf16 two-phase AE: the share of elements differing, at
# most what test_twophase_autoencoder_bf16_per_layer_kind measured (every
# layer fed the JAX layer's own bf16 input): conv 6 of 516,024 elements,
# resblock 110 of 286,144 (0.0384 %, within 2.9e-3 x max|ref|), down 2 of
# 42,240, upsample+conv 1 of 53,760, every other kind bitwise. What differs is
# f32 sums taken in another order (ROADMAP Queue 3 item 1).
_TP_BOUNDS = {"conv": 1.2e-5, "swish": 0.0, "resblock": 3.9e-4, "down": 4.8e-5, "GN+swish": 0.0,
              "SABlock": 0.0, "upsample+conv": 1.9e-5, "upsample": 0.0}


def _kind(specs, i):
    s = specs[i]
    if s.kind == "gn":
        return "GN+swish" if i + 1 < len(specs) and specs[i + 1].kind == "swish" else "GN"
    if s.kind == "conv" and s.kw.get("upsample_2x") or s.kind == "up":
        return "upsample+conv"
    return {"resize": "upsample", "sablock": "SABlock"}.get(s.kind, s.kind)


def test_twophase_autoencoder_bf16_per_layer_kind(tp_params):
    """The bf16 two-phase autoencoder layer by layer against ``lns_tpu``'s
    bf16 AE on the same converted weights: each port layer, through a
    forward pre-hook, takes the jitted JAX layer's bf16 input, and a
    forward hook compares its output with the JAX layer's. Per layer kind:
    the largest error at most 1e-2 x max|ref| and the share of differing
    elements at most ``_TP_BOUNDS``."""
    jae, params, ae, x = _ae_pair(tp_params, jnp.bfloat16)
    found = {}  # kind -> [max err / max|ref|, elements differing, elements]

    def jax_layer(part, spec, fuse):
        def fn(m, x):
            if spec.kind == "swish":
                return jswish(x)
            if spec.kind == "resize":
                kw = spec.kw
                return x if kw.get("fused") else resize_nearest_torch(x, kw["out_h"], kw["out_w"])
            y = getattr(m, part)._layers[spec.name](x)
            return jswish(y) if fuse else y
        return jax.jit(lambda p, x: jae.apply({"params": p}, x, method=fn))

    def run(part, x0):
        seq = getattr(ae, part)
        specs, hooks, want = seq.specs, [], {}
        xj = jnp.asarray(x0, jnp.bfloat16)
        i = 0
        while i < len(specs):  # the JAX chain, layer by layer
            fuse = _kind(specs, i) == "GN+swish"
            yj = jax_layer(part, specs[i], fuse)(params, xj)
            want[i] = (np.asarray(xj.astype(jnp.float32)), np.asarray(yj.astype(jnp.float32)))
            xj, i = yj, i + (2 if fuse else 1)
        for i in want:
            def pre(mod, args, kwargs, i=i):
                return (nchw(want[i][0]).to(torch.bfloat16),) + args[1:], kwargs

            def post(mod, args, kwargs, out, i=i):
                ref, got = want[i][1], nhwc(out)
                assert got.shape == ref.shape, (part, i)
                st = found.setdefault(_kind(specs, i), [0.0, 0, 0])
                st[0] = max(st[0], np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
                st[1] += int((got != ref).sum())
                st[2] += ref.size
            hooks += [seq.model[i].register_forward_pre_hook(pre, with_kwargs=True),
                      seq.model[i].register_forward_hook(post, with_kwargs=True)]
        with torch.no_grad():
            seq(nchw(x0).to(torch.bfloat16))
        for h in hooks:
            h.remove()

    run("encoder", x)
    run("decoder", np.random.default_rng(5).standard_normal((2, 7, 15, 16)).astype(np.float32))
    assert set(found) == set(_TP_BOUNDS)
    report = ", ".join(f"{k} {e:.2e} x max|ref| {n / t:.4%}" for k, (e, n, t) in sorted(found.items()))
    for kind, (err, n, total) in found.items():
        assert err <= 1e-2 and n / total <= _TP_BOUNDS[kind], \
            f"{kind}: {n / total:.4%} differ (<= {_TP_BOUNDS[kind]:.4%}); all: {report}"


# -- the converter ---------------------------------------------------------------------

def test_twophase_state_dict_from_jax_matches_export(tp_params):
    """Key for key and value for value the state dict that the JAX
    package's exporter writes for the two-phase model, loaded strictly."""
    ref = export_latent_dynamics(JConfig(_tp_dict()), tp_params)
    ours = state_dict_from_jax(Config(_tp_dict()), {"params": tp_params})
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    load(LatentDynamics(Config(_tp_dict()), device="cpu"), ours)  # strict


def test_twophase_full_size_keys_shapes_and_predict():
    """At ``twophase_config()``'s full widths the converter's keys and
    shapes are the port model's own (from the JAX init's shapes alone), the
    state dict loads strictly, and ``LatentDynamics`` built on the CPU
    predicts finite fields of the right shape (batch 1, 2 steps)."""
    cfg = twophase_config()
    jmodel = JLatentDynamics(JConfig(cfg.to_dict()))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), (1, 61, 121, 4)))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    state = state_dict_from_jax(cfg, params)
    model = LatentDynamics(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    load(model, state)  # strict
    init_weights_(model, torch.Generator().manual_seed(8))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 61, 121, 4))
                         .astype(np.float32))
    y = model.predict(x, 2)
    assert y.shape == (1, 2, 61, 121, 4) and torch.isfinite(y).all()
    assert model.propagator.padding_mode == "zeros"


# -- the propagator, the rollout and predict -----------------------------------------

def test_zeros_propagator_step_and_rollout_match_jax():
    """One zeros SimpleCNN step within 3e-4 of the JAX module, and
    ``fused_rollout_plain`` over 4 steps (a CPU tensor takes it) within
    3e-4 of the JAX fused rollout in interpret mode and of the JAX
    package's XLA scan (``predict_latents``' path in zeros mode), at the
    7x15 latent and dilation 2."""
    nb, c, dil, c_lat = 2, 32, 2, 16
    jcnn = JSimpleCNN(c_lat, nb, c, dil, "zeros")
    z = np.random.default_rng(6).standard_normal((2, 7, 15, c_lat)).astype(np.float32)
    params = perturb(jcnn.init(jax.random.PRNGKey(6), jnp.asarray(z))["params"], 6, 0.05)
    step = jax.jit(lambda p, z: jcnn.apply({"params": p}, z))
    ref = np.asarray(step(params, jnp.asarray(z)))
    cnn = load(SimpleCNN(c_lat, nb, c, dil, padding_mode="zeros"),
               propagator_state_dict(Config(prop_n_block=nb), params))
    with torch.no_grad():
        np.testing.assert_allclose(cnn(torch.from_numpy(z)).numpy(), ref, atol=3e-4)
    zs = prop_rollout.fused_rollout(torch.from_numpy(z), prop_rollout.pack_simple_cnn(cnn), 4,
                                    nb, dil, "zeros").numpy()
    packed = jpr.pack_simple_cnn_params(params, nb, dtype=jnp.float32)
    pallas = np.asarray(jpr.fused_rollout(jnp.asarray(z), packed, steps=4, n_block=nb,
                                          dilation=dil, padding_mode="zeros", interpret=True))
    np.testing.assert_allclose(zs, pallas, atol=3e-4)
    scan, zj = [], jnp.asarray(z)
    for _ in range(4):
        zj = step(params, zj)
        scan.append(np.asarray(zj))
    np.testing.assert_allclose(zs, np.stack(scan), atol=3e-4)


def test_twophase_predict_matches_jax(tp_params):
    """``LatentDynamics.predict`` (3 steps) within 3e-4 of the JAX
    ``predict`` (the XLA scan, as the JAX package runs zeros mode), the
    port's kernels on and off (their plain versions here)."""
    d = _tp_dict()
    jm = JLatentDynamics(JConfig(d))
    model = load(LatentDynamics(Config(d), device="cpu"), state_dict_from_jax(Config(d), tp_params))
    x = np.random.default_rng(7).standard_normal((2, 31, 61, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jm.predict(p, x, 3))(tp_params, jnp.asarray(x)))
    for flag in (True, False):
        out = model.use_kernels(flag).predict(torch.from_numpy(x), 3).numpy()
        assert out.shape == (2, 3, 31, 61, 4)
        np.testing.assert_allclose(out, ref, atol=3e-4, err_msg=f"kernels {flag}")
    model.use_kernels(True)


def test_gradient_domain_loss_matches_jax():
    """``gradient_domain_loss`` (vof dropped, and kept) within atol 1e-6
    of the JAX function, on [b, t, h, w, 4] fields."""
    rng = np.random.default_rng(9)
    pred, gt = (rng.standard_normal((2, 3, 13, 17, 4)).astype(np.float32) for _ in range(2))
    for drop in (True, False):
        ref = float(jgradient_domain_loss(jnp.asarray(pred), jnp.asarray(gt), weight_space=0.7,
                                          drop_last_channel=drop))
        out = float(gradient_domain_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                                         weight_space=0.7, drop_last_channel=drop))
        np.testing.assert_allclose(out, ref, atol=1e-6)


# -- the corpora and the datasets -----------------------------------------------------

def _same_dir(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb
    for f in fa:
        with np.load(os.path.join(a, f)) as x, np.load(os.path.join(b, f)) as y:
            assert sorted(x.files) == sorted(y.files)
            assert all(x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files)


def test_sloshing_and_synthetic_corpora_match_jax(tmp_path):
    """``make_sloshing_dir`` (both ``vary`` modes) and ``make_twophase_dir``
    write the JAX package's files, bitwise."""
    for vary in ("depth", "freq"):
        kw = dict(ncase=3, case_len=4, h=13, w=21, seed=5, vary=vary)
        _same_dir(jsloshing.make_sloshing_dir(str(tmp_path / f"j{vary}"), **kw),
                  sloshing_solver.make_sloshing_dir(str(tmp_path / f"p{vary}"), **kw))
    kw = dict(ncase=3, case_len=4, h=13, w=21, seed=6)
    _same_dir(jsynthetic.make_twophase_dir(str(tmp_path / "js"), **kw),
              synthetic.make_twophase_dir(str(tmp_path / "ps"), **kw))


def test_twophase_datasets_match_jax(tmp_path):
    """On a sloshing corpus with 64 rows (clipped to 61), ``TankSloshingStage1``,
    ``TankSloshingStage2`` (with the window quirk and without) and
    ``SimpleTankSloshingData``, their ``eval_trajectories``, ``denormalize``
    (numpy; a tensor gives the same values) and the stats file equal the
    JAX datasets', bitwise."""
    data = sloshing_solver.make_sloshing_dir(str(tmp_path / "d"), ncase=10, case_len=7, h=64,
                                             w=20, seed=4, vary="depth")
    d = dict(data_dir=data, dataset_stat=str(tmp_path / "stat.npz"), case_len=7, num_case=10,
             in_tw=1, out_tw=2)
    for quirk in (False, True):
        for train_mode in (True, False):
            cfgs = (JConfig(d, window_quirk=quirk), Config(d, window_quirk=quirk))
            j1 = jtwophase.TankSloshingStage1(cfgs[0], train_mode)
            p1 = twophase.TankSloshingStage1(cfgs[1], train_mode)
            assert len(j1) == len(p1) and p1.fields.shape[2] == 61
            idx = np.random.default_rng(10).permutation(len(j1))
            traj = p1.eval_trajectories()
            for a, b in ((p1.get_batch(idx), j1.get_batch(idx)),
                         (traj, j1.eval_trajectories()),
                         (p1.denormalize(traj),
                          np.asarray(j1.denormalize(j1.eval_trajectories())))):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            assert torch.equal(p1.denormalize(torch.from_numpy(traj)),
                               torch.from_numpy(p1.denormalize(traj)))
            j2 = jtwophase.TankSloshingStage2(cfgs[0], train_mode)
            p2 = twophase.TankSloshingStage2(cfgs[1], train_mode)
            js = jtwophase.SimpleTankSloshingData(cfgs[0], train_mode)
            ps = twophase.SimpleTankSloshingData(cfgs[1], train_mode)
            assert len(j2) == len(p2) == len(js) == len(ps)
            idx = np.arange(len(j2))
            for a, b in zip(p2.eval_trajectories(), j2.eval_trajectories()):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(ps.get_batch(idx), js.get_batch(idx)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            ks = (1.0, -2.0)
            j2.encode_dataset(lambda x: np.concatenate([x[:, ::4, ::4] * k for k in ks], -1),
                              batch=4)
            p2.encode_dataset(lambda x: torch.cat([x[:, ::4, ::4] * k for k in ks], -1), "cpu",
                              batch=4)
            for a, b in zip(p2.get_batch(idx), j2.get_batch(idx)):
                assert a.shape == b.shape and np.array_equal(a, b)
    with np.load(d["dataset_stat"], allow_pickle=True) as s:
        assert {"vel_mean", "vel_std", "prs_mean", "prs_std"} <= set(s.files)


def test_denormalize_bf16_promotes_as_jax(tmp_path):
    """``denormalize`` on a bf16 tensor: the masked velocity comes out in
    f32 (the f32 wall mask), and with it the whole field, value for value
    the JAX package's on the same bf16 array, called as its trainers call
    it (op by op, outside ``jit``: each bf16 op rounds)."""
    data = synthetic.make_twophase_dir(str(tmp_path / "d"), ncase=4, case_len=3, h=9, w=11, seed=3)
    d = dict(data_dir=data, dataset_stat=None, case_len=3, num_case=4)
    p1 = twophase.TankSloshingStage1(Config(d), True)
    j1 = jtwophase.TankSloshingStage1(JConfig(d), True)
    x = np.random.default_rng(3).standard_normal((2, 9, 11, 4)).astype(np.float32)
    ref = np.asarray(j1.denormalize(jnp.asarray(x, jnp.bfloat16)))
    out = p1.denormalize(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(out.numpy(), ref)


# -- the trainers side by side and the CLIs ---------------------------------------------

def _data_cfg(tmp, **over):
    """The test-size two-phase model on a synthetic corpus of 10 cases x 6
    frames of 31x61 (9 training cases, 1 test case): stage 1 takes 54
    frames (7 steps of batch 8, the last of 6), stage 2 27 windows (out_tw
    2; 3 steps of batch 8) and a validation rollout of 5 steps."""
    os.makedirs(tmp, exist_ok=True)
    data = synthetic.make_twophase_dir(os.path.join(tmp, "tp"), ncase=10, case_len=6, h=31,
                                       w=61, seed=11, with_freq=False)
    d = _tp_dict()
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


def test_twophase_stage1_trainer_matches_jax(tmp_path):
    """One two-phase epoch of the port's stage-1 trainer (7 steps, f32) from
    the JAX trainer's parameters: finite losses; the first step's loss (on
    denormalised fields) within rel 1e-4 of the JAX trainer's on the same
    batch and weights; the first validation's ``val_recon_loss`` and the
    per-channel ``val_recon_loss_{vx,vy,prs,vof}`` within rel 1e-4; a
    sample grid per channel written."""
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
    for f in ("sample_vx_0.png", "gt_vof_final.png", "err_curve_final.png"):
        assert os.path.exists(os.path.join(pt.cfg.log_dir, "samples", f)), f


def test_twophase_stage2_trainer_matches_jax(tmp_path):
    """One two-phase epoch of the port's stage-2 trainer (3 steps, f32,
    noise 0), both trainers loading one stage-1 ``.pt`` that
    ``torch_export`` wrote, from the same propagator parameters: the encode
    pre-pass within 3e-4 of the JAX trainer's; finite losses, the first
    step's loss within rel 1e-4 of the JAX ``rollout_loss`` on the same
    windows; the first validation's ``val_seq_rel_l2`` and the per-channel
    ``val_pred_loss_{vx,vy,prs,vof}`` within rel 1e-4; a sample grid per
    channel written."""
    d = _data_cfg(str(tmp_path), out_tw=2, noise_level=0.0)
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
    z_in, z_out = pt.train_ds.get_batch(first)
    jloss = float(jax.jit(jt.model.rollout_loss)(jt.params, jnp.asarray(z_in),
                                                 jnp.asarray(z_out)))
    pt.train()
    pl = _metrics(pt.cfg.log_dir, "loss")
    assert len(pl) == 3 and np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl[0], jloss, rtol=1e-4)
    _check_validation(jt, pt, ("val_seq_rel_l2",) + tuple(f"val_pred_loss_{n}" for n in _NAMES),
                      str(tmp_path / "jval"))
    for f in ("sample_vx_0.png", "gt_vof_1.png", "err_curve_1.png"):
        assert os.path.exists(os.path.join(pt.cfg.log_dir, "samples", f)), f


def test_twophase_clis_train_on_the_cpu(tmp_path):
    """``python -m lns_tpu_torch.cli.train_stage1`` and ``train_stage2``
    with a two-phase YAML, ``--device cpu --no-wandb``: one epoch each, the
    second on the first's final checkpoint; both write their metrics and
    final checkpoints."""
    import yaml

    from lns_tpu_torch.cli import train_stage1, train_stage2

    d1 = _data_cfg(str(tmp_path), ckpt_every=9, log_dir=str(tmp_path / "s1"))
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
