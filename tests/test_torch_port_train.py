"""Stage-2 training in the port against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through ``lns_tpu`` and
``lns_tpu_torch`` at the test-size NS2d model (``small_ns2d_dict``), f32:
the losses, the optimizer and its schedule, ``rollout_loss`` (loss and
gradients), the NS2d latent corpus, and the two stage-2 trainers side by
side. Then tests of the port alone: resume, the device-resident corpus, the
device rule, the kernels' gradient guard, kernel 3's autograd Function and
the CLI. Each tolerance is stated where it is used.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lns_tpu.config import Config as JConfig
from lns_tpu.data import synthetic as jsynthetic
from lns_tpu.data.ns2d import NS2DStage2 as JNS2DStage2
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.ops import losses as jlosses
from lns_tpu.train import Stage2Trainer as JStage2Trainer
from lns_tpu.train import optim as joptim
from lns_tpu.utils.torch_compat import convert_latent_dynamics
from lns_tpu.utils.torch_export import export_autoencoder, save_torch_checkpoint
from lns_tpu_torch.config import Config
from lns_tpu_torch.data import synthetic
from lns_tpu_torch.data.ns2d import NS2DStage2
from lns_tpu_torch.kernels import _build, axial, axial_pipeline, fab_core, group_norm, prop_rollout
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.ops import losses
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.train import optim, stage2
from lns_tpu_torch.utils.convert import propagator_state_dict, state_dict_from_jax

from _torch_port import perturb, small_ns2d_dict, to_np


def _data_cfg(tmp, **over):
    """The test-size model with a synthetic corpus of 10 cases x 6 frames
    (9 training cases of 3 windows, one validation case of 5 steps)."""
    os.makedirs(tmp, exist_ok=True)
    d = small_ns2d_dict()
    d.update(data_dir=synthetic.make_ns2d_npz(os.path.join(tmp, "ns2d.npz"), ncase=10,
                                              case_len=6, h=32, w=32),
             case_len=6, num_case=10, dataset_stat=None, batch_size=4, epochs=1,
             learning_rate=5e-4, ckpt_every=1, log_dir=os.path.join(tmp, "log"),
             overwrite_exist=True, noise_level=0.0)
    d.update(over)
    return d


def _metrics(log_dir, key):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _no_figures(monkeypatch):
    """The figures take most of a validation's time on the CPU and are
    tested by the trainers' side-by-side test and the CLI test."""
    monkeypatch.setattr(stage2, "log_sequence", lambda *a: None)
    monkeypatch.setattr(stage2, "plot_error_curve", lambda *a: None)


# -- losses, optimizer, rollout_loss ------------------------------------------

LOSS_CASES = [
    ("relative_lp_loss", dict(reduction="sum")),
    ("relative_lp_loss", dict(reduction="mean")),
    ("relative_lp_loss", dict(reduction="sum", reduce_all=True)),
    ("relative_lp_loss", dict(reduce_dim=(1, 2, 3), reduction="sum", p=2)),
    ("pointwise_correlation", {}),
    ("smooth_l1_loss", dict(reduction="mean")),
    ("smooth_l1_loss", dict(reduction="sum")),
    ("smooth_l1_loss", dict(reduction="none")),
]


@pytest.mark.parametrize("name,kw", LOSS_CASES)
def test_losses_match_jax(name, kw):
    """Each loss and reduction against ``lns_tpu.ops.losses``, atol 1e-6
    (f32 sums in another order); a zero ground-truth sample takes the eps
    floor."""
    rng = np.random.default_rng(11)
    pred = rng.standard_normal((3, 4, 6, 5, 2)).astype(np.float32)
    gt = (rng.standard_normal((3, 4, 6, 5, 2)) * 1.5).astype(np.float32)
    gt[0] = 0.0
    ref = np.asarray(getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(gt), **kw))
    out = getattr(losses, name)(torch.from_numpy(pred), torch.from_numpy(gt), **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_stage2_optimizer_matches_optax():
    """The same gradients over 3 epochs x 4 steps through optax's Adam with
    the cosine schedule and through the port's Adam + LambdaLR: the lr of
    every step within rel 1e-6 (optax computes it in f32) and the
    parameters after every step within 1e-6 (f32 rounding of the update)."""
    cfg = Config(learning_rate=1e-3, epochs=3)
    spe, rng = 4, np.random.default_rng(12)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(12)]
    tx = joptim.stage2_optimizer(JConfig(learning_rate=1e-3, epochs=3), spe)
    sched = joptim.cosine_annealing_per_epoch(1e-3, 3, spe)
    jp = [jnp.asarray(p) for p in p0]
    state, update = tx.init(jp), jax.jit(tx.update)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    opt, lr_sched = optim.stage2_optimizer(cfg, tp, spe)
    for k, g in enumerate(grads):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(k)), rtol=1e-6)
        updates, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
        lr_sched.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6)
    # after the last epoch the epoch index is clamped at `epochs`: eta_min
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-6, rel=1e-9)


@pytest.fixture(scope="module")
def prop_models():
    d = small_ns2d_dict()
    jmodel = JLatentDynamics(JConfig(d))
    z = np.random.default_rng(13).standard_normal((3, 1, 4, 4, 16)).astype(np.float32)
    init = jax.jit(jmodel.propagator.init)(jax.random.PRNGKey(3), jnp.asarray(z[:, 0]))["params"]
    params = perturb(init, 13, 0.05)
    model = LatentDynamics(Config(d), device="cpu")
    model.propagator.load_state_dict(propagator_state_dict(Config(d), params), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("t_out", [2, 3])
def test_rollout_loss_and_gradients_match_jax(prop_models, t_out, remat):
    """Loss within rel 1e-5 and every gradient within 1e-5 x max|g| of
    ``jax.value_and_grad`` of ``LatentDynamics.rollout_loss`` (f32, sums
    in another order), the JAX gradients mapped to the port's names and
    layouts by ``propagator_state_dict``."""
    jmodel, params, model = prop_models
    rng = np.random.default_rng(14 + t_out)
    z_in = rng.standard_normal((3, 1, 4, 4, 16)).astype(np.float32)
    z_out = rng.standard_normal((3, t_out, 4, 4, 16)).astype(np.float32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda pp: jmodel.rollout_loss({"propagator": pp}, jnp.asarray(z_in), jnp.asarray(z_out),
                                       remat=remat)))(jax.tree.map(jnp.asarray, params))
    ref = propagator_state_dict(model.cfg, to_np(grads_j))
    model.zero_grad(set_to_none=True)
    loss = model.rollout_loss(torch.from_numpy(z_in), torch.from_numpy(z_out), remat=remat)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    grads = {k: p.grad for k, p in model.propagator.named_parameters()}
    assert grads.keys() == ref.keys()
    for k, g in grads.items():
        scale = ref[k].abs().max().item()
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=1e-5 * scale, err_msg=k)


def test_rollout_loss_kernel_route_gives_the_plain_gradient(prop_models):
    """On the CPU the GroupNorms' kernel route (``GroupNormSwishFunction``
    under grad) gives the same loss and gradients, bitwise, as
    ``use_kernels(False)`` (autograd through the plain version)."""
    _, _, model = prop_models
    rng = np.random.default_rng(15)
    z_in = torch.from_numpy(rng.standard_normal((2, 1, 4, 4, 16)).astype(np.float32))
    z_out = torch.from_numpy(rng.standard_normal((2, 2, 4, 4, 16)).astype(np.float32))
    out = {}
    for flag in (True, False):
        model.use_kernels(flag).zero_grad(set_to_none=True)
        loss = model.rollout_loss(z_in, z_out)
        loss.backward()
        out[flag] = (loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                                     if p.grad is not None})
    model.use_kernels(True)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1].keys() == out[False][1].keys()
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


# -- the NS2d latent corpus ----------------------------------------------------

def test_ns2d_stage2_matches_jax(tmp_path):
    """The port's ``make_ns2d_npz`` writes the JAX package's bytes; with the
    same encode function, the split, statistics, every window and the eval
    trajectories are equal bitwise, on the host and on the device path."""
    jpath = jsynthetic.make_ns2d_npz(str(tmp_path / "j.npz"), ncase=11, case_len=7, seed=3)
    ppath = synthetic.make_ns2d_npz(str(tmp_path / "p.npz"), ncase=11, case_len=7, seed=3)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    d = dict(data_dir=ppath, case_len=7, num_case=11, out_tw=2, interval=1)
    ks = (1.0, -2.0, 3.0)
    for train_mode in (True, False):
        jds = JNS2DStage2(JConfig(d, dataset_stat=str(tmp_path / f"js{train_mode}.npz")),
                          train_mode)
        pds = NS2DStage2(Config(d, dataset_stat=str(tmp_path / f"ps{train_mode}.npz")),
                         train_mode)
        np.testing.assert_array_equal(pds.idxs, jds.idxs)
        assert np.array_equal(pds.data, jds.data) and len(pds) == len(jds)
        for k in ("mean", "std"):
            assert np.array_equal(pds.stats[k], jds.stats[k]), k
        for a, b in zip(pds.eval_trajectories(), jds.eval_trajectories()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if not train_mode:
            continue
        jds.encode_dataset(lambda x: np.concatenate([x[:, ::8, ::8] * k for k in ks], -1),
                           batch=16)
        idx = np.arange(len(jds))
        ref = jds.get_batch(idx)
        pds.encode_dataset(lambda x: torch.cat([x[:, ::8, ::8] * k for k in ks], -1), "cpu",
                           batch=16)
        for a, b in zip(pds.get_batch(idx), ref):
            assert a.shape == b.shape and np.array_equal(a, b)
        # a stats file written by one package is read by the other
        assert NS2DStage2(Config(d, dataset_stat=str(tmp_path / "jsTrue.npz"))).stats["std"] \
            == jds.stats["std"]


# -- the trainers side by side -------------------------------------------------

@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX trainer and the port's, one epoch each on one synthetic
    config (noise 0, f32), both loading one stage-1 ``.pt`` that
    ``torch_export`` wrote; the port then takes the JAX trainer's initial
    parameters through ``state_dict_from_jax``.

    The JAX trainer's initial parameters come from the port's seeded init
    through ``torch_compat`` (its eager flax init takes half a minute on
    the CPU), with seeded noise on every leaf."""
    tmp = str(tmp_path_factory.mktemp("s2"))
    d = _data_cfg(tmp)
    jcfg = JConfig(d)
    sd = init_weights_(LatentDynamics(Config(d), device="cpu"), torch.Generator().manual_seed(21))
    params = perturb(convert_latent_dynamics(jcfg, {k: v.numpy() for k, v in
                                                    sd.state_dict().items()}), 21, 0.02)
    ae_path = os.path.join(tmp, "ae.pt")
    save_torch_checkpoint(export_autoencoder(jcfg, params["vq_ae"]), ae_path)
    d.update(pretrained_checkpoint_path=ae_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLatentDynamics, "init", lambda self, key, shape: {"params": params})
        jt = JStage2Trainer(JConfig(d, log_dir=os.path.join(tmp, "jlog")), seed=5,
                            use_wandb=False)
    pt = stage2.Stage2Trainer(Config(d, log_dir=os.path.join(tmp, "plog")), seed=5,
                              use_wandb=False, device="cpu")
    encoded = pt.train_ds.encoded.copy()
    pt.model.load_state_dict(state_dict_from_jax(pt.cfg, to_np(jt.params)), strict=True)
    ae0 = {k: v.clone() for k, v in pt.model.vq_ae.state_dict().items()}
    prop0 = {k: v.clone() for k, v in pt.model.propagator.state_dict().items()}
    jt.train()
    pt.train()
    return jt, pt, params["vq_ae"], ae_path, encoded, ae0, prop0


def test_trainers_side_by_side(trainers):
    """Per-step losses and ``val_seq_rel_l2`` (before and after the epoch)
    within rel 1e-4 of the JAX trainer's (f32 on the CPU, sums in another
    order), and the final propagator parameters' change over the epoch
    within 1e-2 x (steps x lr), the most Adam can move one in this run:
    an update is lr x m / (sqrt(v) + eps), whose rounding is relative to
    the update, not to the parameter (where a gradient is near zero the
    two frameworks' updates can differ by a sizeable share of lr). The AE
    is the loaded one, bitwise."""
    jt, pt, _, ae_path, _, ae0, prop0 = trainers
    assert pt.steps_per_epoch == 6
    jl, pl = _metrics(jt.cfg.log_dir, "loss"), _metrics(pt.cfg.log_dir, "loss")
    assert len(jl) == len(pl) == 6
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jv, pv = _metrics(jt.cfg.log_dir, "val_seq_rel_l2"), _metrics(pt.cfg.log_dir, "val_seq_rel_l2")
    assert len(jv) == len(pv) == 2
    np.testing.assert_allclose(pv, jv, rtol=1e-4)
    ref = propagator_state_dict(pt.cfg, to_np(jt.prop_params))
    bound = 1e-2 * pt.steps_per_epoch * pt.cfg.learning_rate
    for k, v in pt.model.propagator.state_dict().items():
        assert not torch.equal(v, prop0[k]), k
        np.testing.assert_allclose((v - prop0[k]).numpy(), (ref[k] - prop0[k]).numpy(),
                                   atol=bound, err_msg=k)
    saved = torch.load(ae_path, weights_only=True)
    for k, v in pt.model.vq_ae.state_dict().items():
        assert torch.equal(v, ae0[k]) and torch.equal(v, saved[k]), k
    ckpt = os.path.join(pt.cfg.log_dir, "checkpoints")
    for f in ("model_0.pt", "model_best.pt", "model_final.pt", "optim_final.pt",
              "meta_final.json", "meta_best.json"):
        assert os.path.exists(os.path.join(ckpt, f)), f
    with open(os.path.join(ckpt, "meta_final.json")) as f:
        assert json.load(f).keys() == {"epoch", "seed", "best_val", "best_epoch"}
    for f in ("sample_0.png", "gt_1.png", "err_curve_1.png"):
        assert os.path.exists(os.path.join(pt.cfg.log_dir, "samples", f)), f


def test_exported_autoencoder_encodes_as_jax(trainers):
    """The stage-1 ``.pt`` that ``torch_export`` wrote loads strictly into
    the port's trainer, whose latent corpus matches the JAX trainer's
    within 3e-4 (the JAX package's own bound for its AE against the torch
    reference, tests/test_torch_export.py) and whose encode of fresh frames
    matches the JAX encode within 3e-4."""
    jt, pt, jae, _, encoded, _, _ = trainers
    np.testing.assert_allclose(encoded, np.asarray(jt.train_ds.encoded), atol=3e-4)
    x = np.random.default_rng(22).standard_normal((2, 32, 32, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(jt.model.encode)({"vq_ae": jax.tree.map(jnp.asarray, jae)},
                                              jnp.asarray(x)))
    with torch.no_grad():
        out = pt.model.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-4)


# -- the port alone --------------------------------------------------------------

def _trained(tmp, monkeypatch, **over):
    _no_figures(monkeypatch)
    d = _data_cfg(tmp, **over)
    t = stage2.Stage2Trainer(Config(d), seed=7, use_wandb=False, device="cpu")
    t.train()
    return t


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_resume_is_bit_identical(tmp_path, monkeypatch, noise):
    """A run of 2 epochs, and a run resumed from its ``model_1``: the
    resumed run restores the epoch, the optimizer's step count and the lr,
    and its losses and final parameters are the uninterrupted run's,
    bitwise (the noise is drawn from (seed, epoch, step))."""
    a = _trained(str(tmp_path / "a"), monkeypatch, epochs=2, noise_level=noise)
    ckpt = os.path.join(a.cfg.log_dir, "checkpoints", "model_1.pt")
    d = _data_cfg(str(tmp_path / "b"), epochs=2, noise_level=noise, resume_training=True,
                  resume_ckpt=ckpt)
    b = stage2.Stage2Trainer(Config(d), seed=7, use_wandb=False, device="cpu")
    assert b.start_epoch == 1 and b.sched.last_epoch == a.steps_per_epoch
    steps = {int(s["step"].item()) for s in b.opt.state_dict()["state"].values()}
    assert steps == {a.steps_per_epoch}
    b.train()
    assert _metrics(b.cfg.log_dir, "loss") == _metrics(a.cfg.log_dir, "loss")[a.steps_per_epoch:]
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert b.opt.param_groups[0]["lr"] == a.opt.param_groups[0]["lr"]


def test_device_data_matches_host_batches(tmp_path, monkeypatch):
    """``device_data`` (the windows on the device, batches gathered there)
    gives the host batches' losses and parameters, bitwise."""
    a = _trained(str(tmp_path / "a"), monkeypatch, ckpt_every=9)
    b = _trained(str(tmp_path / "b"), monkeypatch, ckpt_every=9, device_data=True)
    assert b.device_data and not a.device_data
    assert _metrics(a.cfg.log_dir, "loss") == _metrics(b.cfg.log_dir, "loss")
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_trainer_needs_cuda_unless_cpu(tmp_path):
    """Without a CUDA card the trainer refuses to build on its default
    device, and leaves no log directory behind."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    d = _data_cfg(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage2.Stage2Trainer(Config(d), use_wandb=False)
    assert not os.path.exists(d["log_dir"])


def _guarded_calls(t):
    """Each of kernels 1, 2 and 4-7 called on CPU tensors `t(shape)`."""
    packed = prop_rollout.PackedSimpleCNN(*(t(s) for s in (
        (4, 32), (32,), (1, 2, 32), (1, 2, 32), (1, 3, 3, 3, 32, 32), (1, 3, 32),
        (1, 2, 32, 32), (32,), (32,), (32, 4), (4,))))
    return {
        "fused_rollout": lambda: prop_rollout.fused_rollout(t((2, 4, 4, 4)), packed, 1, 1, 2,
                                                            "circular"),
        "fab_fused_core": lambda: fab_core.fab_fused_core(
            t((1, 4, 4, 16)), t((1, 2, 4, 4)), t((1, 2, 4, 4)), t((16, 2, 8)), t((2, 8, 16))),
        "fab_axial_in_fused": lambda: axial.fab_axial_in_fused(
            t((1, 2, 4, 4)), t((1, 2, 4, 4)), t((1, 2, 4, 4, 8))),
        "axial_kernel_apply_headmajor": lambda: axial.axial_kernel_apply_headmajor(
            t((2, 4, 4)), t((2, 4, 4)), t((2, 4, 4, 8))),
        "bmm_blockdiag": lambda: axial_pipeline.bmm_blockdiag(t((1, 2, 4, 4)), t((1, 2, 4, 8))),
        "transpose_hw": lambda: axial_pipeline.transpose_hw(t((1, 2, 4, 4, 8))),
    }


def test_kernels_refuse_a_gradient_before_launching(monkeypatch):
    """With the device test of ``_build.on_cuda`` reporting a card, each of
    kernels 1, 5, 6 and 7, and kernel 4 with its norm, raises a
    RuntimeError naming itself when grad mode is on and an input requires
    grad, before it builds or launches anything; without grad it goes on to
    the launch. Kernels 2 and 3, and kernel 4 in the d-space core's mode
    (norm off, stats, heads last), go on to their launch under grad (their
    autograd Functions)."""

    class Launched(Exception):
        pass

    def library():
        raise Launched

    monkeypatch.setattr(_build, "is_card", lambda t, name: True)
    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(axial, "_limit", lambda *a: None)
    with_grad = {"fab_fused_core"}
    for name, call in _guarded_calls(lambda s: torch.ones(s, requires_grad=True)).items():
        if name in with_grad:
            with pytest.raises(Launched):
                call()
        else:
            with pytest.raises(RuntimeError, match=f"{name}: the kernel has no gradient"):
                call()
        with torch.no_grad(), pytest.raises(Launched):
            call()
    for name, call in _guarded_calls(lambda s: torch.ones(s)).items():
        with pytest.raises(Launched):
            call()
    x, w = torch.ones(2, 4, 4, 8, requires_grad=True), torch.ones(8)
    with pytest.raises(Launched):
        group_norm.fused_group_norm_swish(x, w, w, 2)
    k, phi = torch.ones(1, 2, 4, 4, requires_grad=True), torch.ones(1, 4, 4, 2, 8)
    with pytest.raises(Launched):
        axial.fab_axial_in_fused(k, k, phi, False, stats=True, heads_last=True)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_function_gives_the_plain_gradient(dtype, swish):
    """``GroupNormSwishFunction`` (its forward the plain version on the
    CPU) returns the plain version's output and gradients for x, scale and
    bias, bitwise, on a channels-last view as ``GroupNorm.forward`` feeds it."""
    rng = np.random.default_rng(23)
    x0 = torch.from_numpy(rng.standard_normal((2, 8, 3, 5)).astype(np.float32) * 2 + 0.5)
    s0 = torch.from_numpy(rng.standard_normal(8).astype(np.float32) * 0.1 + 1)
    b0 = torch.from_numpy(rng.standard_normal(8).astype(np.float32) * 0.1)
    gy = torch.from_numpy(rng.standard_normal((2, 3, 5, 8)).astype(np.float32)).to(dtype)
    out = []
    for fn in (group_norm.GroupNormSwishFunction.apply, group_norm.group_norm_swish_plain):
        x = x0.to(dtype).to(memory_format=torch.channels_last).requires_grad_(True)
        s, b = s0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y = fn(x.movedim(1, -1).contiguous(), s, b, 4, 1e-5, swish)
        y.backward(gy)
        out.append((y.detach(), x.grad, s.grad, b.grad))
    for a, b in zip(*out):
        assert a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b)


def test_cli_trains_one_epoch_on_the_cpu(tmp_path):
    """``python -m lns_tpu_torch.cli.train_stage2 --config <yaml> --device
    cpu --no-wandb`` trains one epoch from a YAML file and writes the log
    tree, the metrics and the final checkpoints."""
    import yaml

    from lns_tpu_torch.cli import train_stage2

    d = _data_cfg(str(tmp_path), ckpt_every=9)
    path = tmp_path / "s2.yml"
    path.write_text(yaml.safe_dump(d))
    train_stage2.main(["--config", str(path), "--device", "cpu", "--no-wandb", "--seed", "3"])
    log = d["log_dir"]
    assert len(_metrics(log, "loss")) == 6 and len(_metrics(log, "val_seq_rel_l2")) == 2
    for f in ("config.yaml", "config.json", "checkpoints/model_final.pt",
              "checkpoints/optim_final.pt", "code_cache/lns_tpu_torch/train/stage2.py"):
        assert os.path.exists(os.path.join(log, f)), f
    with open(os.path.join(log, "checkpoints", "meta_final.json")) as f:
        assert json.load(f)["seed"] == 3
