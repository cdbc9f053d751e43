"""Data-parallel training in the port (``lns_tpu_torch.parallel``) on the
CPU, against the JAX package's trainers on a 2-device mesh.

Each port run is two processes joined by gloo (a ``file://`` rendezvous
under the test's directory, no TCP port), each importing torch and the
port only (``_WORKER``: it fails if jax or the JAX package was imported).
The JAX trainers run on two of ``conftest.py``'s virtual CPU devices with
``mesh=``; both start from the same parameters (the port's seeded init
through ``torch_compat`` with seeded noise, as the single-device
side-by-side tests do), f32, noise 0. Then the port alone: two ranks
against one process over the same global batches, with and without
input noise, rank 0 alone writing the run directory, and a 2-rank resume
against the uninterrupted 2-rank run. Tolerances are stated per test.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lns_tpu.config import Config as JConfig
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.parallel.mesh import batch_sharding, data_mesh
from lns_tpu.parallel.mesh import pad_to_multiple as jpad_to_multiple
from lns_tpu.train import Stage2Trainer as JStage2Trainer
from lns_tpu.train import stage1 as jstage1
from lns_tpu.train import stage2 as jstage2
from lns_tpu.utils.torch_compat import convert_latent_dynamics
from lns_tpu.utils.torch_export import export_autoencoder, save_torch_checkpoint
from lns_tpu_torch.config import Config
from lns_tpu_torch.data import epoch_batches, sloshing_solver, synthetic
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.parallel import ddp
from lns_tpu_torch.train import stage2
from lns_tpu_torch.utils.convert import state_dict_from_jax

from _torch_port import perturb, small_ns2d_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank of a port run: argv[1] is a JSON spec (cfg, stage, seed, out,
# init). A rank other than 0 may write nothing under the run directory: its
# open-for-writing and makedirs there raise. Each rank saves its final
# parameters to out/rank{r}.pt.
_WORKER = r"""
import builtins, json, os, sys
import torch
torch.set_num_threads(1)
from lns_tpu_torch.config import Config
from lns_tpu_torch.parallel import ddp
from lns_tpu_torch.train import checkpoint, stage1, stage2

spec = json.loads(sys.argv[1])
for mod in (stage1, stage2):  # the figures are tested elsewhere
    mod.log_sequence = lambda *a: None
    mod.plot_error_curve = lambda *a: None
dev = ddp.init_from_env("cpu", init_method=spec["init"])
cfg = Config(spec["cfg"])
if ddp.rank() != 0:
    log = os.path.abspath(cfg.log_dir)
    real_open, real_makedirs = builtins.open, os.makedirs

    def inside(path):
        return os.path.abspath(str(path)).startswith(log)

    def guarded_open(f, mode="r", *a, **k):
        if inside(f) and any(c in mode for c in "wax+"):
            raise RuntimeError(f"rank {ddp.rank()} opened {f} for writing")
        return real_open(f, mode, *a, **k)

    def guarded_makedirs(path, *a, **k):
        if inside(path):
            raise RuntimeError(f"rank {ddp.rank()} made {path}")
        return real_makedirs(path, *a, **k)

    builtins.open, os.makedirs = guarded_open, guarded_makedirs
trainer = (stage1.Stage1Trainer if spec["stage"] == 1 else stage2.Stage2Trainer)(
    cfg, seed=spec["seed"], use_wandb=False, device=dev)
assert (trainer.logger is None) == (ddp.rank() != 0)
trainer.train()
torch.save(checkpoint.state_dict_cpu(trainer.model),
           os.path.join(spec["out"], f"rank{ddp.rank()}.pt"))
ddp.shutdown()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lns_tpu"))
if bad:
    raise RuntimeError(f"a rank imported {bad[:5]}")
"""


def _start_ranks(tmp, cfg_dict, stage, seed=5, world=2):
    """Start `world` gloo ranks of the port's trainer on `cfg_dict`; returns
    the processes and the directory of their final parameters."""
    out = os.path.join(tmp, "ranks")
    os.makedirs(out, exist_ok=True)
    spec = json.dumps(dict(cfg=cfg_dict, stage=stage, seed=seed, out=out,
                           init="file://" + os.path.join(tmp, "rendezvous")))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, spec], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs, out


def _finish(procs, out, timeout=240):
    """Wait for the ranks; each must exit 0. Returns each rank's final
    parameters."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
            for r in range(len(procs))]


def _metrics(log_dir, key):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _no_jax_figures(mp):
    for mod in (jstage1, jstage2):
        mp.setattr(mod, "log_sequence", lambda *a: None)
        mp.setattr(mod, "plot_error_curve", lambda *a: None)


def _ns2d_cfg(tmp, **over):
    """The test-size NS2d model on 10 synthetic cases x 6 frames of 32x32:
    stage 2 has 27 windows (6 steps of the global batch 4), stage 1 54
    frames (6 steps of batch 8 on two ranks, the last partial batch
    dropped)."""
    os.makedirs(tmp, exist_ok=True)
    d = small_ns2d_dict()
    d.update(data_dir=synthetic.make_ns2d_npz(os.path.join(tmp, "ns2d.npz"), ncase=10,
                                              case_len=6, h=32, w=32),
             case_len=6, num_case=10, dataset_stat=None, batch_size=4, epochs=1,
             learning_rate=5e-4, ckpt_every=1, overwrite_exist=True, noise_level=0.0)
    d.update(over)
    return d


def _cond_cfg(tmp, **over):
    """The test-size conditional two-phase model on a ``make_sloshing_dir(
    vary="freq")`` corpus of 10 cases x 6 frames of 31x61: 27 windows, 3
    steps of the global batch 8 (26 windows in two shards of 13 on the
    device path)."""
    data = os.path.join(tmp, "freq")
    sloshing_solver.make_sloshing_dir(data, ncase=10, case_len=6, h=31, w=61, seed=11,
                                      vary="freq")
    d = graft._tiny_cond_cfg().to_dict()
    d.update(data_dir=data, dataset_stat=os.path.join(tmp, "stat.npz"), case_len=6, num_case=10,
             batch_size=8, epochs=1, learning_rate=5e-4, ckpt_every=1, overwrite_exist=True)
    d.update(over)
    return d


def _stage2_start(tmp, d, seed):
    """The stage-2 starting point of both packages: seeded port init ->
    JAX tree + noise; the AE as a ``torch_export`` stage-1 ``.pt`` (the
    trainers' pretrained AE) and the whole model as ``init.pt`` (the port
    ranks' resume point: parameters only, no sidecars, so epoch 0)."""
    jcfg = JConfig(d)
    sd = init_weights_(LatentDynamics(Config(d), device="cpu"),
                       torch.Generator().manual_seed(seed))
    params = perturb(convert_latent_dynamics(jcfg, {k: v.numpy() for k, v in
                                                    sd.state_dict().items()}), seed, 0.02)
    ae_path, init_path = os.path.join(tmp, "ae.pt"), os.path.join(tmp, "init.pt")
    save_torch_checkpoint(export_autoencoder(jcfg, params["vq_ae"]), ae_path)
    torch.save(state_dict_from_jax(Config(d), params), init_path)
    d.update(pretrained_checkpoint_path=ae_path)
    return params, init_path


# -- the helpers ----------------------------------------------------------------

def test_shards_and_orders_match_the_jax_mesh():
    """``shard_rows`` gives rank r the rows ``shard_batch`` puts on device r
    of a 2- and a 4-device mesh; ``pad_to_multiple`` is the JAX one's; at
    one rank ``stratified_batches`` is ``epoch_batches(drop_last=True)``
    (``rng.permutation(n)`` shuffles ``arange(n)``); a global batch that
    does not divide over the ranks raises."""
    x = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
    for world in (2, 4):
        placed = jax.device_put(x, batch_sharding(data_mesh(jax.devices()[:world])))
        for shard in placed.addressable_shards:
            r = shard.device.id - min(d.id for d in jax.devices()[:world])
            assert np.array_equal(np.asarray(shard.data), ddp.shard_rows(x, r, world))
    for batch in (x[:5], (x[:7], x[:7, 0])):
        ours, n = ddp.pad_to_multiple(batch, 4)
        ref, n_ref = jpad_to_multiple(batch, 4)
        assert n == n_ref
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            assert np.array_equal(a, b)
    for n, b in ((27, 4), (26, 8), (8, 8)):
        one = [i[0] for i in ddp.stratified_batches(np.random.default_rng([5, 1]), n, b, 1)]
        ref = list(epoch_batches(n, b, np.random.default_rng([5, 1]), drop_last=True))
        assert len(one) == len(ref) and all(np.array_equal(a, c) for a, c in zip(one, ref))
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        ddp.shard_rows(np.arange(8), 0, 3)
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        ddp.stratified_batches(np.random.default_rng(0), 30, 8, 3)


def test_one_process_builds_no_wrapper(tmp_path, monkeypatch):
    """Without a process group the trainer's loss module is the plain
    ``RolloutLoss`` (no DDP wrapper), the helpers are the identity, and the
    conditional propagator's zero-initialised gates, though their gradient
    is exactly zero at init, take part in the loss: every parameter gets a
    gradient, as DDP without ``find_unused_parameters`` needs."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert ddp.init_from_env("cpu") == torch.device("cpu") and not ddp.distributed()
    assert ddp.rank() == 0 and ddp.world_size() == 1 and ddp.is_main()
    model = init_weights_(LatentDynamics(Config(graft._tiny_cond_cfg().to_dict()), device="cpu"),
                          torch.Generator().manual_seed(3))
    module = ddp.wrap(stage2.RolloutLoss(model), torch.device("cpu"))
    assert type(module) is stage2.RolloutLoss
    model.autoencoder.requires_grad_(False)
    rng = np.random.default_rng(3)
    z_in = torch.from_numpy(rng.standard_normal((2, 1, 7, 15, 16)).astype(np.float32))
    z_out = torch.from_numpy(rng.standard_normal((2, 2, 7, 15, 16)).astype(np.float32))
    module(z_in, z_out, torch.tensor([0.2, 0.7])).backward()
    grads = {k: p.grad for k, p in model.propagator.named_parameters()}
    assert all(g is not None for g in grads.values())
    zero = [k for k, g in grads.items() if not g.any()]
    assert zero, "the zero-initialised gates give exactly zero gradients at init"


# -- two gloo ranks against the JAX trainers on a 2-device mesh -------------------

S2_CASES = [("ns2d", False), ("conditional", True)]


@pytest.mark.parametrize("family,device_data", S2_CASES,
                         ids=[f"{f}-{'device' if d else 'host'}" for f, d in S2_CASES])
def test_stage2_two_ranks_match_the_jax_mesh(tmp_path, family, device_data):
    """One epoch of stage 2 on two gloo ranks against the JAX trainer with
    ``mesh=`` two CPU devices, f32, noise 0, on the host path (NS2d) and on
    the device path (the conditional family): per-step losses and both
    validations within rel 1e-4 (f32, sums in another order). On the device
    path the JAX trainer's stratified per-shard batches are recorded and
    equal ``stratified_batches``'; the conditional family's parameters are
    sharded with its windows. The two ranks end with the same parameters,
    bitwise."""
    tmp = str(tmp_path)
    make = _ns2d_cfg if family == "ns2d" else _cond_cfg
    d = make(tmp, device_data=device_data)
    params, init_path = _stage2_start(tmp, d, seed=21)
    pd = dict(d, log_dir=os.path.join(tmp, "plog"), resume_training=True, resume_ckpt=init_path)
    procs, out = _start_ranks(tmp, pd, stage=2)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLatentDynamics, "init", lambda self, key, shape: {"params": params})
        _no_jax_figures(mp)
        jt = JStage2Trainer(JConfig(d, log_dir=os.path.join(tmp, "jlog")), seed=5,
                            mesh=data_mesh(jax.devices()[:2]), use_wandb=False)
        if device_data:
            step = jt._train_step_dev
            jt._train_step_dev = lambda *a: (seen.append(np.asarray(a[5])), step(*a))[1]
        jt.train()
    finals = _finish(procs, out)
    jl, pl = _metrics(jt.cfg.log_dir, "loss"), _metrics(pd["log_dir"], "loss")
    assert len(pl) == len(jl) > 0
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jv, pv = _metrics(jt.cfg.log_dir, "val_seq_rel_l2"), _metrics(pd["log_dir"], "val_seq_rel_l2")
    assert len(jv) == len(pv) == 2
    np.testing.assert_allclose(pv, jv, rtol=1e-4)
    if device_data:
        n = len(jt.train_ds)
        ours = list(ddp.stratified_batches(np.random.default_rng([5, 0]), n, d["batch_size"], 2))
        assert len(seen) == len(ours) == len(pl)
        assert all(np.array_equal(a, b) for a, b in zip(seen, ours))
    assert all(torch.equal(v, finals[1][k]) for k, v in finals[0].items())


# -- two ranks against one process ------------------------------------------------

@pytest.fixture(scope="module")
def noisy(tmp_path_factory):
    """Stage 2 (NS2d, host path, input noise 0.01) for 2 epochs on two gloo
    ranks, and in one process over the same global batches, from one
    ``init.pt``."""
    tmp = str(tmp_path_factory.mktemp("noisy"))
    d = _ns2d_cfg(tmp, epochs=2, noise_level=0.01)
    _, init_path = _stage2_start(tmp, d, seed=22)
    d.update(resume_training=True, resume_ckpt=init_path)
    pd = dict(d, log_dir=os.path.join(tmp, "ranks_log"))
    procs, out = _start_ranks(tmp, pd, stage=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stage2, "log_sequence", lambda *a: None)
        mp.setattr(stage2, "plot_error_curve", lambda *a: None)
        one = stage2.Stage2Trainer(Config(d, log_dir=os.path.join(tmp, "one_log")), seed=5,
                                   use_wandb=False, device="cpu")
        one.train()
    return tmp, pd, _finish(procs, out), one


def _close(ranks_state, one_state, rel):
    """Every parameter within `rel` of the one-process run's, relative to
    the tensor's largest magnitude (an element's rounding is relative to
    the update, which is lr-sized, not to the element)."""
    for k, v in one_state.items():
        scale = v.abs().max().item()
        np.testing.assert_allclose(ranks_state[k].numpy(), v.numpy(), rtol=rel,
                                   atol=rel * scale, err_msg=k)


def test_two_ranks_match_one_process(tmp_path, noisy):
    """Over the same global batches, two gloo ranks train what one process
    trains: with noise 0 (one epoch) and with input noise 0.01 (each rank
    draws the global batch's noise and takes its rows; two epochs), the
    per-step losses within rel 1e-5 and the final parameters within rel
    1e-5 (f32: a batch of 2 and a batch of 4 round differently). Rank 0
    alone wrote the run directory (the other rank's writes there raise in
    ``_WORKER``), and it holds each step's loss once."""
    tmp = str(tmp_path)
    d = _ns2d_cfg(tmp)
    _, init_path = _stage2_start(tmp, d, seed=23)
    d.update(resume_training=True, resume_ckpt=init_path)
    pd = dict(d, log_dir=os.path.join(tmp, "ranks_log"))
    procs, out = _start_ranks(tmp, pd, stage=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stage2, "log_sequence", lambda *a: None)
        mp.setattr(stage2, "plot_error_curve", lambda *a: None)
        one = stage2.Stage2Trainer(Config(d, log_dir=os.path.join(tmp, "one_log")), seed=5,
                                   use_wandb=False, device="cpu")
        one.train()
    runs = [(pd, _finish(procs, out), one), noisy[1:]]
    for pdir, finals, one in runs:
        pl, ol = _metrics(pdir["log_dir"], "loss"), _metrics(one.cfg.log_dir, "loss")
        assert len(pl) == len(ol) == one.steps_per_epoch * one.cfg.epochs
        np.testing.assert_allclose(pl, ol, rtol=1e-5)
        _close(finals[0], one.model.state_dict(), 1e-5)
        ckpt = os.path.join(pdir["log_dir"], "checkpoints")
        assert {"model_0.pt", "model_final.pt", "model_best.pt", "meta_best.json"} <= \
            set(os.listdir(ckpt))


def test_two_rank_resume_is_bitwise(tmp_path, noisy):
    """Two ranks resumed from the 2-rank run's ``model_1.pt`` (with input
    noise): the second epoch's losses and the final parameters equal the
    uninterrupted 2-rank run's, bitwise; every rank loaded the checkpoint
    (the ranks' final parameters are equal)."""
    tmp, pd, finals, _ = noisy
    ckpt = os.path.join(pd["log_dir"], "checkpoints", "model_1.pt")
    rd = dict(pd, log_dir=str(tmp_path / "resumed_log"), resume_ckpt=ckpt)
    procs, out = _start_ranks(str(tmp_path), rd, stage=2)
    resumed = _finish(procs, out)
    steps = len(_metrics(pd["log_dir"], "loss")) // 2
    assert _metrics(rd["log_dir"], "loss") == _metrics(pd["log_dir"], "loss")[steps:]
    for r in range(2):
        assert all(torch.equal(v, resumed[r][k]) for k, v in finals[0].items())
