"""Data-parallel stage-1 training in the port on the CPU: two gloo ranks
of ``Stage1Trainer`` against the JAX package's stage-1 trainer on a
2-device mesh (``conftest.py``'s virtual CPU devices), on the host path and
with the frames on the device. The ranks run as ``test_torch_port_ddp.py``
runs them (``_WORKER``: torch and the port only, a ``file://``
rendezvous)."""

import os

import jax
import numpy as np
import pytest
import torch

from lns_tpu.config import Config as JConfig
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.parallel.mesh import data_mesh
from lns_tpu.train import Stage1Trainer as JStage1Trainer
from lns_tpu.utils.torch_compat import convert_autoencoder
from lns_tpu_torch.config import Config
from lns_tpu_torch.models import SimpleAutoencoder
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.utils.convert import state_dict_from_jax

from _torch_port import perturb
from test_torch_port_ddp import _finish, _metrics, _no_jax_figures, _ns2d_cfg, _start_ranks


@pytest.mark.parametrize("device_data", [False, True], ids=["host", "device"])
def test_stage1_two_ranks_match_the_jax_mesh(tmp_path, device_data):
    """One epoch of stage 1 (NS2d, batch 8) on two gloo ranks against the JAX
    trainer on a 2-device mesh, f32: 6 steps (the mesh drops the last
    partial batch on the host path; the device path's stratified order has
    6 steps of 4 per shard of 27), per-step losses and both validations
    within rel 1e-4; the ranks' final parameters bitwise equal."""
    tmp = str(tmp_path)
    d = _ns2d_cfg(tmp, batch_size=8, device_data=device_data)
    jcfg = JConfig(d)
    ae = init_weights_(SimpleAutoencoder(Config(d)), torch.Generator().manual_seed(36))
    params = perturb(convert_autoencoder(jcfg, {k: v.numpy() for k, v in ae.state_dict().items()}),
                     36, 0.02)
    init_path = os.path.join(tmp, "init.pt")
    torch.save(state_dict_from_jax(Config(d), params, kind="ae"), init_path)
    pd = dict(d, log_dir=os.path.join(tmp, "plog"), resume_training=True, resume_ckpt=init_path)
    procs, out = _start_ranks(tmp, pd, stage=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSimpleAutoencoder, "init", lambda self, key, x: {"params": params})
        _no_jax_figures(mp)
        jt = JStage1Trainer(JConfig(d, log_dir=os.path.join(tmp, "jlog")), seed=5,
                            mesh=data_mesh(jax.devices()[:2]), use_wandb=False)
        jt.train()
    finals = _finish(procs, out)
    jl, pl = _metrics(jt.cfg.log_dir, "rec_loss"), _metrics(pd["log_dir"], "rec_loss")
    assert len(pl) == len(jl) == 6
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jv, pv = _metrics(jt.cfg.log_dir, "val_recon_loss"), _metrics(pd["log_dir"], "val_recon_loss")
    assert len(jv) == len(pv) == 2
    np.testing.assert_allclose(pv, jv, rtol=1e-4)
    assert all(torch.equal(v, finals[1][k]) for k, v in finals[0].items())
