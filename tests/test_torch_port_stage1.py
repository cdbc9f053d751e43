"""Stage-1 training in the port against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through ``lns_tpu`` and
``lns_tpu_torch`` at the test-size NS2d model (``small_ns2d_dict``): the
autograd Functions of kernels 2 and 4 against the plain versions' own
gradients, the AE loss and its gradients (f32 and bf16), the optimizer, the
NS2d frame corpus, and the two stage-1 trainers side by side. Then tests of
the port alone: resume, the device-resident corpus, the device rule, the
CLI and the hand-off to stage 2. Each tolerance is stated where it is used.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lns_tpu.config import Config as JConfig
from lns_tpu.data import synthetic as jsynthetic
from lns_tpu.data.ns2d import NS2DStage1 as JNS2DStage1
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.train import Stage1Trainer as JStage1Trainer
from lns_tpu.train import optim as joptim
from lns_tpu.train import stage1 as jstage1
from lns_tpu.utils.torch_compat import convert_autoencoder
from lns_tpu.utils.torch_export import export_autoencoder
from lns_tpu_torch.config import Config
from lns_tpu_torch.data import synthetic
from lns_tpu_torch.data.ns2d import NS2DStage1
from lns_tpu_torch.kernels import axial, fab_core, group_norm
from lns_tpu_torch.models import SimpleAutoencoder
from lns_tpu_torch.models.specs import decoder_spec, encoder_spec
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.train import optim, stage1, stage2
from lns_tpu_torch.train.logging_utils import MetricLogger

from _torch_port import perturb, small_ns2d_dict, to_np


def _data_cfg(tmp, **over):
    """The test-size model with a synthetic corpus of 10 cases x 6 frames
    of 32x32 (54 training frames, 7 steps of batch 8 per epoch, the last of
    6; one validation case of 6 frames)."""
    os.makedirs(tmp, exist_ok=True)
    d = small_ns2d_dict()
    d.update(data_dir=synthetic.make_ns2d_npz(os.path.join(tmp, "ns2d.npz"), ncase=10,
                                              case_len=6, h=32, w=32),
             case_len=6, num_case=10, dataset_stat=None, batch_size=8, epochs=1,
             learning_rate=5e-4, ckpt_every=1, log_dir=os.path.join(tmp, "log"),
             overwrite_exist=True)
    d.update(over)
    return d


def _metrics(log_dir, key):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _no_figures(monkeypatch):
    """The figures take most of a validation's time on the CPU and are
    tested by the trainers' side-by-side test and the CLI test."""
    monkeypatch.setattr(stage1, "log_sequence", lambda *a: None)
    monkeypatch.setattr(stage1, "plot_error_curve", lambda *a: None)


def _normed_away(cfg):
    """The conv biases whose gradient is zero in exact arithmetic: a
    ResidualBlock's first conv feeds its second GroupNorm(32), which at 32
    channels (one channel per group) subtracts the bias again. Their
    computed gradients are rounding noise in both packages."""
    return {f"{part}.model.{s.idx}.block.2.bias"
            for part, specs in (("encoder", encoder_spec(cfg)), ("decoder", decoder_spec(cfg)))
            for s in specs if s.kind == "resblock" and s.kw["out_channels"] == 32}


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


# -- the autograd Functions of kernels 2 and 4 ---------------------------------

@pytest.mark.parametrize("hw", [(6, 4), (4, 6)], ids=["w<=h", "w>h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fab_core_function_gives_the_plain_gradient(dtype, hw):
    """``FabCoreFunction`` (its forward the plain version on the CPU)
    returns ``fab_core_plain``'s output and the gradients that autograd
    gives through it, bitwise, for u, k_x, k_y and the two 1x1 conv weights
    that w_in and w_o1 are views of (as ``FABlock2D`` passes them: f32
    parameters, u and the kernels in the activation dtype); w > h takes the
    transposed field. ``fab_fused_core`` under grad goes through it."""
    h, w = hw
    b, n, d, c, o = 2, 2, 8, 16, 16
    rng = np.random.default_rng(31)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    u0, kx0, ky0 = arr(b, h, w, c), arr(b, n, h, h, scale=0.3), arr(b, n, w, w, scale=0.3)
    wi0, wo0 = arr(n * d, c, 1, 1, scale=0.25), arr(o, n * d, 1, 1, scale=0.1)
    gy = arr(b, h, w, o).to(dtype)
    out = []
    for fn in (fab_core.FabCoreFunction.apply, fab_core.fab_core_plain):
        u, kx, ky = (t.to(dtype).requires_grad_() for t in (u0, kx0, ky0))
        wi, wo = wi0.clone().requires_grad_(), wo0.clone().requires_grad_()
        w_in = wi[:, :, 0, 0].t().reshape(c, n, d)
        w_o1 = wo[:, :, 0, 0].t().reshape(n, d, o)
        y = fn(u, kx, ky, w_in, w_o1, 1e-5)
        y.backward(gy)
        out.append((y.detach(), u.grad, kx.grad, ky.grad, wi.grad, wo.grad))
    for name, a, r in zip(("out", "u", "k_x", "k_y", "in_proj", "to_out[1]"), *out):
        assert a.dtype == r.dtype and torch.equal(a, r), name
    y = fab_core.fab_fused_core(u0.requires_grad_(), kx0, ky0, wi0[:, :, 0, 0].t().reshape(c, n, d),
                                wo0[:, :, 0, 0].t().reshape(n, d, o))
    assert type(y.grad_fn).__name__ == "FabCoreFunctionBackward"


@pytest.mark.parametrize("hw", [(6, 4), (4, 6)], ids=["w<=h", "w>h"])
def test_fab_core_function_with_block_mean_gives_the_plain_gradient(hw):
    """bf16 with ``mean_from`` (the block's input x, the GroupNorm's sc and
    sh, the kernels' f32 sums; as ``FABlock2D`` passes them):
    ``FabCoreFunction`` returns ``fab_core_plain``'s output and gradients
    bitwise, for u, k_x, k_y, the two conv weights and the two sums; x and
    the coefficients get none (the residue they give the mean has no
    gradient)."""
    h, w = hw
    b, n, d, c, o = 2, 2, 8, 16, 16
    rng = np.random.default_rng(32)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x0 = arr(b, h, w, c).bfloat16()
    u0, coef = group_norm.group_norm_swish_plain(x0, 1 + 0.1 * arr(c), 0.1 * arr(c), 1, 1e-5,
                                                 apply_swish=False, with_coef=True)
    kx0, ky0 = arr(b, n, h, h, scale=0.3), arr(b, n, w, w, scale=0.3)
    sx0, sy0 = kx0.sum(2) + 1e-3 * arr(b, n, h), ky0.sum(2) + 1e-3 * arr(b, n, w)
    wi0, wo0 = arr(n * d, c, 1, 1, scale=0.25), arr(o, n * d, 1, 1, scale=0.1)
    gy = arr(b, h, w, o).bfloat16()
    out = []
    for fn in (fab_core.FabCoreFunction.apply, fab_core.fab_core_plain):
        u, kx, ky = (t.bfloat16().requires_grad_() for t in (u0, kx0, ky0))
        x, sx, sy = (t.clone().requires_grad_() for t in (x0, sx0, sy0))
        wi, wo = wi0.clone().requires_grad_(), wo0.clone().requires_grad_()
        w_in = wi[:, :, 0, 0].t().reshape(c, n, d)
        w_o1 = wo[:, :, 0, 0].t().reshape(n, d, o)
        if fn is fab_core.fab_core_plain:
            y = fn(u, kx, ky, w_in, w_o1, 1e-5, (x, coef, sx, sy))
        else:
            y = fn(u, kx, ky, w_in, w_o1, 1e-5, x, coef, sx, sy)
        y.backward(gy)
        out.append((y.detach(), u.grad, kx.grad, ky.grad, wi.grad, wo.grad, sx.grad, sy.grad))
        assert x.grad is None or not x.grad.any()
    for name, a, r in zip(("out", "u", "k_x", "k_y", "in_proj", "to_out[1]", "kx_s", "ky_s"),
                          *out):
        assert a.dtype == r.dtype and torch.equal(a, r), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_axial_in_function_gives_the_plain_gradient(dtype):
    """``AxialInFunction`` returns ``fab_axial_in_plain``'s two outputs
    (x, and the f32 statistics) in the d-space core's mode (norm off,
    stats, heads last) and, for seeded upstream gradients of both, the
    gradients autograd gives through the plain version for kx, ky and phi,
    bitwise. ``fab_axial_in_fused`` under grad goes through it in that mode
    only."""
    b, n, h, w, d = 2, 2, 5, 6, 8
    rng = np.random.default_rng(32)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    kx0, ky0, phi0 = arr(b, n, h, h, scale=0.3), arr(b, n, w, w, scale=0.3), arr(b, h, w, n, d)
    gx, gs = arr(b, h, w, n, d).to(dtype), arr(b, n, d, 2, scale=0.01)
    out = []
    for fn in (axial.AxialInFunction.apply,
               lambda kx, ky, phi, eps: axial.fab_axial_in_plain(kx, ky, phi, False, eps, True,
                                                                 True)):
        kx, ky, phi = (t.to(dtype).requires_grad_() for t in (kx0, ky0, phi0))
        x, stats = fn(kx, ky, phi, 1e-5)
        torch.autograd.backward((x, stats), (gx, gs))
        out.append((x.detach(), stats.detach(), kx.grad, ky.grad, phi.grad))
    for name, a, r in zip(("x", "stats", "kx", "ky", "phi"), *out):
        assert a.dtype == r.dtype and torch.equal(a, r), name
    kx, ky, phi = (t.requires_grad_() for t in (kx0, ky0, phi0))
    x, _ = axial.fab_axial_in_fused(kx, ky, phi, False, stats=True, heads_last=True)
    assert type(x.grad_fn).__name__ == "AxialInFunctionBackward"
    y = axial.fab_axial_in_fused(kx, ky, phi.permute(0, 3, 1, 2, 4))  # the norm on: plain autograd
    assert type(y.grad_fn).__name__ != "AxialInFunctionBackward"


# -- the AE loss and its gradients against jax.value_and_grad -----------------

@pytest.fixture(scope="module")
def ae_case():
    """The test model with encoder attention (its 8x8 c64 FAB takes the
    d-space core, kernel 4; the others the c-space core, kernel 2), JAX
    parameters from the port's seeded init with seeded noise on every leaf,
    a seeded batch of 4 frames, and the JAX f32 loss and gradients
    (``Stage1Trainer._loss`` differentiated by ``jax.value_and_grad``)."""
    d = small_ns2d_dict()
    d["use_attn_enc"] = True
    jcfg = JConfig(d)
    ae = init_weights_(SimpleAutoencoder(Config(d)), torch.Generator().manual_seed(33))
    params = perturb(convert_autoencoder(jcfg, {k: v.numpy() for k, v in ae.state_dict().items()}),
                     33, 0.02)
    x = np.random.default_rng(33).standard_normal((4, 32, 32, 1)).astype(np.float32)
    return d, params, x, _jax_loss_and_grads(d, params, x, None)


def _jax_loss_and_grads(d, params, x, dtype):
    """``lns_tpu.train.stage1.Stage1Trainer._loss`` (with the JAX AE at
    `dtype`) under ``jax.value_and_grad``, jitted; the gradients mapped to
    the reference's names and layouts by ``torch_export``, as the
    parameters are."""
    jcfg = JConfig(d)
    host = types.SimpleNamespace(model=JSimpleAutoencoder(jcfg, dtype=dtype), loss_on_denorm=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, xx: JStage1Trainer._loss(host, p, xx)))(jax.tree.map(jnp.asarray, params),
                                                          jnp.asarray(x))
    return float(loss), _tensors(export_autoencoder(jcfg, to_np(grads)))


def _port_loss_and_grads(d, params, x, dtype):
    model = SimpleAutoencoder(Config(d), dtype=dtype)
    model.load_state_dict(_tensors(export_autoencoder(JConfig(d), params)), strict=True)
    loss = stage1.reconstruction_loss(model, torch.from_numpy(x))
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def test_autoencoder_loss_and_gradients_match_jax_f32(ae_case):
    """f32: the port's stage-1 loss (``reconstruction_loss``, what
    ``Stage1Trainer._loss`` computes) within rel 1e-5 of the JAX
    loss, and every gradient within 1e-4 x max|g| of the JAX gradient of
    the same tensor (sums in another order through some 40 layers). The
    biases that a GroupNorm subtracts again (``_normed_away``) have zero
    gradient in exact arithmetic: both packages' are held within 1e-6 of
    the largest gradient of the model."""
    d, params, x, (loss_j, ref) = ae_case
    loss, grads = _port_loss_and_grads(d, params, x, None)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    assert grads.keys() <= ref.keys() and len(grads) > 100
    top = max(g.abs().max().item() for g in ref.values())
    zero = _normed_away(Config(d))
    assert len(zero) == 4
    for k, g in grads.items():
        if k in zero:
            assert max(g.abs().max().item(), ref[k].abs().max().item()) <= 1e-6 * top, k
            continue
        scale = ref[k].abs().max().item()
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=1e-4 * scale, err_msg=k)
    for part in ("encoder.model.9", "decoder.model.8"):  # a d-space and a c-space FAB
        for name in ("in_proj.weight", "to_out.1.weight", "in_norm.weight", "in_norm.bias",
                     "low_rank_kernel_x.to_qk.weight", "low_rank_kernel_y.to_qk.weight"):
            assert grads[f"{part}.{name}"].abs().max() > 0, f"{part}.{name}"


def test_autoencoder_gradients_bf16_as_accurate_as_jax(ae_case):
    """bf16 activations (f32 parameters and loss): both packages round the
    forward and backward in bf16 at different points (XLA keeps some fused
    backward intermediates in f32); at this size the JAX package's own bf16
    gradients are a median 24 % (up to 46 %, relative L2) from its f32
    ones, and the two packages' bf16 gradients a median cosine 0.989 from
    each other. Held per tensor to accuracy parity: the port's bf16
    gradient no farther from the JAX f32 gradient than 2 x the JAX bf16
    gradient is (L2 distance; for the biases a GroupNorm subtracts again,
    whose f32 gradient is ~0, the size of the rounding noise). The loss
    within rel 2e-3 of the JAX bf16 loss (half a bf16 ulp)."""
    d, params, x, (_, ref32) = ae_case
    loss_j, ref = _jax_loss_and_grads(d, params, x, jnp.bfloat16)
    loss, grads = _port_loss_and_grads(d, params, x, torch.bfloat16)
    np.testing.assert_allclose(loss, loss_j, rtol=2e-3)
    worst = (0.0, None)
    for k, g in grads.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
        dist_port = (g.double() - ref32[k].double()).norm().item()
        dist_jax = (ref[k].double() - ref32[k].double()).norm().item()
        worst = max(worst, (dist_port / max(dist_jax, 1e-30), k))
    assert worst[0] <= 2.0, worst


# -- optimizer and corpus -------------------------------------------------------

def test_stage1_optimizer_matches_optax():
    """The same gradients over 8 steps through optax's Adam
    (``lns_tpu.train.optim.stage1_optimizer``) and the port's torch Adam,
    with the config's betas and with the defaults: the parameters after
    every step within 1e-6 (f32 rounding of the update)."""
    rng = np.random.default_rng(34)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(8)]
    for over in ({}, {"beta1": 0.5, "beta2": 0.9}):
        tx = joptim.stage1_optimizer(JConfig(learning_rate=1e-3, **over))
        jp = [jnp.asarray(p) for p in p0]
        state, update = tx.init(jp), jax.jit(tx.update)
        tp = [torch.tensor(p, requires_grad=True) for p in p0]
        opt = optim.stage1_optimizer(Config(learning_rate=1e-3, **over), tp)
        assert opt.param_groups[0]["betas"] == (over.get("beta1", 0.9), over.get("beta2", 0.999))
        for g in grads:
            updates, state = update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, updates)
            for t, x in zip(tp, g):
                t.grad = torch.from_numpy(x)
            opt.step()
            for t, j in zip(tp, jp):
                np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6)


def test_ns2d_stage1_matches_jax(tmp_path):
    """On one ``make_ns2d_npz`` corpus: the split, length, statistics,
    every training frame and the eval trajectories equal the JAX
    package's, bitwise, in both modes."""
    path = jsynthetic.make_ns2d_npz(str(tmp_path / "c.npz"), ncase=11, case_len=7, seed=4)
    d = dict(data_dir=path, case_len=7, num_case=11)
    for train_mode in (True, False):
        jds = JNS2DStage1(JConfig(d, dataset_stat=str(tmp_path / f"j{train_mode}.npz")), train_mode)
        pds = NS2DStage1(Config(d, dataset_stat=str(tmp_path / f"p{train_mode}.npz")), train_mode)
        np.testing.assert_array_equal(pds.idxs, jds.idxs)
        assert len(pds) == len(jds) == (63 if train_mode else 2)
        for k in ("mean", "std"):
            assert np.array_equal(pds.stats[k], jds.stats[k]), k
        idx = np.random.default_rng(35).permutation(len(jds))
        for a, b in ((pds.get_batch(idx), jds.get_batch(idx)),
                     (pds.eval_trajectories(), jds.eval_trajectories())):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape and np.array_equal(a, b)


# -- the trainers side by side -------------------------------------------------

@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX trainer and the port's, one epoch each on one synthetic
    config (f32), from the same parameters: the port's seeded init through
    ``torch_compat`` with seeded noise on every leaf, given to the JAX
    trainer in place of its flax init and to the port through
    ``torch_export``."""
    tmp = str(tmp_path_factory.mktemp("s1"))
    d = _data_cfg(tmp)
    jcfg = JConfig(d)
    ae = init_weights_(SimpleAutoencoder(Config(d)), torch.Generator().manual_seed(36))
    params = perturb(convert_autoencoder(jcfg, {k: v.numpy() for k, v in ae.state_dict().items()}),
                     36, 0.02)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSimpleAutoencoder, "init", lambda self, key, x: {"params": params})
        jt = JStage1Trainer(JConfig(d, log_dir=os.path.join(tmp, "jlog")), seed=5,
                            use_wandb=False)
    pt = stage1.Stage1Trainer(Config(d, log_dir=os.path.join(tmp, "plog")), seed=5,
                              use_wandb=False, device="cpu")
    pt.model.load_state_dict(_tensors(export_autoencoder(jcfg, params)), strict=True)
    p0 = {k: v.clone() for k, v in pt.model.state_dict().items()}
    with pytest.MonkeyPatch.context() as mp:  # the port's figures are checked, not the JAX ones
        mp.setattr(jstage1, "log_sequence", lambda *a: None)
        mp.setattr(jstage1, "plot_error_curve", lambda *a: None)
        jt.train()
    pt.train()
    return jt, pt, p0


def test_trainers_side_by_side(trainers):
    """Per-step losses and ``val_recon_loss`` (before and after the epoch)
    within rel 1e-4 of the JAX trainer's (f32 on the CPU, sums in another
    order), and every parameter tensor's change over the epoch within 1e-2
    of the JAX one's (relative L2): Adam's update lr x m / (sqrt(v) + eps)
    rounds relative to the update, not to the parameter, and an element
    whose gradient is near zero takes about lr x sign(g) at the first step,
    so one such element can differ by up to 2 lr between the packages; the
    relative L2 of the whole tensor's change bounds the rest without hiding
    a wrong tensor. The biases a GroupNorm subtracts again
    (``_normed_away``) are left out: their whole gradient is rounding
    noise, which Adam scales up to updates of about lr in either package.
    The checkpoint files and figures are written."""
    jt, pt, p0 = trainers
    jl, pl = _metrics(jt.cfg.log_dir, "rec_loss"), _metrics(pt.cfg.log_dir, "rec_loss")
    assert len(jl) == len(pl) == 7
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jv, pv = _metrics(jt.cfg.log_dir, "val_recon_loss"), _metrics(pt.cfg.log_dir, "val_recon_loss")
    assert len(jv) == len(pv) == 2
    np.testing.assert_allclose(pv, jv, rtol=1e-4)
    ref = _tensors(export_autoencoder(jt.cfg, to_np(jt.params)))
    zero = _normed_away(pt.cfg)
    for k, p in pt.model.named_parameters():
        if k in zero:
            continue
        moved, moved_j = (p.detach() - p0[k]).double(), (ref[k] - p0[k]).double()
        assert moved.norm() > 0, k
        assert (moved - moved_j).norm() <= 1e-2 * moved_j.norm(), k
    ckpt = os.path.join(pt.cfg.log_dir, "checkpoints")
    for f in ("vqgan_epoch_0.pt", "optim_epoch_0.pt", "vqgan_epoch_best.pt",
              "meta_epoch_best.json", "vqgan_epoch_final.pt", "optim_epoch_final.pt",
              "meta_epoch_final.json"):
        assert os.path.exists(os.path.join(ckpt, f)), f
    with open(os.path.join(ckpt, "meta_epoch_final.json")) as f:
        assert json.load(f).keys() == {"epoch", "seed", "best_val", "best_epoch"}
    for f in ("sample_0.png", "gt_final.png", "err_curve_final.png"):
        assert os.path.exists(os.path.join(pt.cfg.log_dir, "samples", f)), f


def test_validate_matches_jax(trainers, tmp_path):
    """``validate`` on the JAX trainer's final parameters: the port's within
    rel 1e-5 of the JAX trainer's own final validation (the same f32
    function on the CPU, sums in another order)."""
    jt, pt, _ = trainers
    trained = {k: v.clone() for k, v in pt.model.state_dict().items()}
    logger = pt.logger
    pt.logger = MetricLogger(str(tmp_path), use_wandb=False)
    try:
        pt.model.load_state_dict(_tensors(export_autoencoder(jt.cfg, to_np(jt.params))))
        val = pt.validate("check")
    finally:
        pt.logger.finish()
        pt.logger = logger
        pt.model.load_state_dict(trained)
    np.testing.assert_allclose(val, _metrics(jt.cfg.log_dir, "val_recon_loss")[-1], rtol=1e-5)


# -- the port alone --------------------------------------------------------------

def _trained(tmp, monkeypatch, **over):
    _no_figures(monkeypatch)
    t = stage1.Stage1Trainer(Config(_data_cfg(tmp, **over)), seed=7, use_wandb=False,
                             device="cpu")
    t.train()
    return t


def test_resume_is_bit_identical(tmp_path, monkeypatch):
    """A run of 2 epochs, and a run resumed from its ``vqgan_epoch_1`` with
    another seed passed: the resumed run restores the epoch, the seed (so
    the batch order), the optimizer's state and the best validation, and
    its losses and final parameters are the uninterrupted run's, bitwise."""
    a = _trained(str(tmp_path / "a"), monkeypatch, epochs=2)
    ckpt = os.path.join(a.cfg.log_dir, "checkpoints", "vqgan_epoch_1.pt")
    d = _data_cfg(str(tmp_path / "b"), epochs=2, resume_training=True, resume_ckpt=ckpt)
    b = stage1.Stage1Trainer(Config(d), seed=99, use_wandb=False, device="cpu")
    assert b.start_epoch == 1 and b.seed == 7 and b.best_epoch in (0, 1)
    assert {int(s["step"].item()) for s in b.opt.state_dict()["state"].values()} == {7}
    b.train()
    assert _metrics(b.cfg.log_dir, "rec_loss") == _metrics(a.cfg.log_dir, "rec_loss")[7:]
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_device_data_matches_host_batches(tmp_path, monkeypatch):
    """``device_data`` (the frames on the device, batches gathered there)
    gives the host batches' losses and parameters, bitwise."""
    a = _trained(str(tmp_path / "a"), monkeypatch, ckpt_every=9)
    b = _trained(str(tmp_path / "b"), monkeypatch, ckpt_every=9, device_data=True)
    assert b.device_data and not a.device_data
    assert _metrics(a.cfg.log_dir, "rec_loss") == _metrics(b.cfg.log_dir, "rec_loss")
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_trainer_needs_cuda_unless_cpu(tmp_path):
    """Without a CUDA card the trainer refuses to build on its default
    device and leaves no log directory behind."""
    d = _data_cfg(str(tmp_path))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.Stage1Trainer(Config(d), use_wandb=False)
    assert not os.path.exists(d["log_dir"])


def test_cli_trains_one_epoch_on_the_cpu(tmp_path):
    """``python -m lns_tpu_torch.cli.train_stage1 --config <yaml> --device
    cpu --no-wandb`` trains one epoch from a YAML file and writes the log
    tree, the metrics and the final checkpoints."""
    import yaml

    from lns_tpu_torch.cli import train_stage1

    d = _data_cfg(str(tmp_path), ckpt_every=9)
    path = tmp_path / "s1.yml"
    path.write_text(yaml.safe_dump(d))
    train_stage1.main(["--config", str(path), "--device", "cpu", "--no-wandb", "--seed", "3"])
    log = d["log_dir"]
    assert len(_metrics(log, "rec_loss")) == 7 and len(_metrics(log, "val_recon_loss")) == 2
    for f in ("config.yaml", "config.json", "checkpoints/vqgan_epoch_final.pt",
              "checkpoints/optim_epoch_final.pt", "checkpoints/vqgan_epoch_best.pt",
              "code_cache/lns_tpu_torch/train/stage1.py"):
        assert os.path.exists(os.path.join(log, f)), f
    with open(os.path.join(log, "checkpoints", "meta_epoch_final.json")) as f:
        assert json.load(f)["seed"] == 3


def test_final_checkpoint_loads_into_stage2(tmp_path, monkeypatch):
    """A stage-1 ``vqgan_epoch_final.pt`` of the port loads strictly into
    the port's ``Stage2Trainer`` as its pretrained AE, bitwise."""
    a = _trained(str(tmp_path / "s1"), monkeypatch, ckpt_every=9)
    path = os.path.join(a.cfg.log_dir, "checkpoints", "vqgan_epoch_final.pt")
    d = _data_cfg(str(tmp_path / "s2"), pretrained_checkpoint_path=path, batch_size=4)
    t = stage2.Stage2Trainer(Config(d), seed=1, use_wandb=False, device="cpu")
    sd = t.model.vq_ae.state_dict()
    assert sd.keys() == a.model.state_dict().keys()
    for k, v in a.model.state_dict().items():
        assert torch.equal(sd[k], v), k
