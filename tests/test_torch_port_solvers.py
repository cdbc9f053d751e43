"""The port's corpus solvers (``lns_tpu_torch.data.ns2d_solver``,
``sw_solver``), the NS2d generator CLI and the data-parallel predict
(``lns_tpu_torch.parallel.ddp.sharded_predict``, ``gather_rows``) against
the JAX package on the CPU.

The initial fields are the JAX package's bitwise (numpy on the host); the
trajectories are held to 1e-5 x max|ref| at short horizons (XLA fuses
products into FMAs and its FFTs are not torch's, so the last bits differ).
The written files have the JAX layout and load through the port's
datasets. ``sharded_predict`` runs on two gloo ranks (``python -c``
processes importing torch and the port only, a ``file://`` rendezvous)
against the JAX predict jitted with the batch sharded on a 2-device mesh,
for the three families ``dryrun_multichip`` shards.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lns_tpu.config import Config as JConfig
from lns_tpu.data import ns2d_solver as jns2d
from lns_tpu.data import sw_solver as jsw
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.parallel.mesh import (batch_sharding, data_mesh, make_global_batch,
                                   replicated_sharding)
from lns_tpu.utils.torch_compat import convert_latent_dynamics
from lns_tpu_torch.cli import generate_ns2d
from lns_tpu_torch.config import Config
from lns_tpu_torch.data import ns2d_solver, sw_solver
from lns_tpu_torch.data.ns2d import NS2DStage1
from lns_tpu_torch.data.shallow_water import CHANNELS, SWStage1
from lns_tpu_torch.data.zarr_reader import open_zarr
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.utils.convert import state_dict_from_jax

from _torch_port import perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# measured: NS2d within 2.6e-7 x max|ref| at every record, SW within 2.6e-7
# (u, v, pres); stated bound 1e-5
TOL = 1e-5


def _close(out, ref, what):
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= TOL, f"{what}: {err:.3e} x max|ref| (bound {TOL})"


# -- the solvers ----------------------------------------------------------------------

@pytest.mark.parametrize("n, ncase, seed", [(32, 2, 1), (64, 3, 0), (17, 1, 5)])
def test_gaussian_random_field_bitwise(n, ncase, seed):
    ref = jns2d.gaussian_random_field(np.random.default_rng(seed), n, ncase)
    out = ns2d_solver.gaussian_random_field(np.random.default_rng(seed), n, ncase)
    assert out.dtype == ref.dtype == np.float32 and np.array_equal(out, ref)


@pytest.mark.parametrize("ncase, h, w, seed", [(2, 16, 32, 3), (3, 96, 192, 7)])
def test_initial_eta_bitwise(ncase, h, w, seed):
    ref = jsw._initial_eta(np.random.default_rng(seed), ncase, h, w)
    out = sw_solver._initial_eta(np.random.default_rng(seed), ncase, h, w)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_simulate_ns2d_matches_jax():
    """``tests/test_ns2d_solver.py``'s settings (32x32, 2 cases,
    t_record 0.2, 4 records of 200 steps, dt 1e-3): every record within
    1e-5 x max|ref| of the JAX function's; finite, zero-mean, evolving."""
    w0 = jns2d.gaussian_random_field(np.random.default_rng(1), 32, 2)
    kw = dict(visc=1e-3, t_record=0.2, n_records=4, dt=1e-3)
    ref = jns2d.simulate_ns2d(w0, **kw)
    out = ns2d_solver.simulate_ns2d(w0, device="cpu", **kw)
    assert out.shape == ref.shape == (2, 4, 32, 32) and out.dtype == np.float32
    for r in range(4):
        _close(out[:, r], ref[:, r], f"record {r}")
    assert np.abs(out.mean(axis=(2, 3))).max() < 1e-3
    assert np.abs(out[:, 0] - out[:, -1]).max() > 1e-3


def test_simulate_sw_matches_jax():
    """A 16x32 channel, 2 cases, 1 spin-up record and 4 records of 25 RK4
    steps: u, v and pres within 1e-5 x max|ref| of the JAX function's at
    every record; v zero on the wall rows."""
    eta0 = jsw._initial_eta(np.random.default_rng(3), 2, 16, 32)
    ref = jsw.simulate_sw(eta0, n_records=4, spinup_records=1)
    out = sw_solver.simulate_sw(eta0, n_records=4, spinup_records=1, device="cpu")
    for name, a, b in zip(CHANNELS, out, ref):
        assert a.shape == b.shape == (2, 4, 16, 32) and a.dtype == np.float32
        for r in range(4):
            _close(a[:, r], b[:, r], f"{name} record {r}")
    assert not out[1][:, :, [0, -1]].any()


def test_simulate_sw_raises_on_blow_up():
    """A time step far past stability: both raise ``FloatingPointError``."""
    eta0 = jsw._initial_eta(np.random.default_rng(3), 1, 8, 16, amp=0.5)
    kw = dict(dt=0.5, t_record=2.0, n_records=20, spinup_records=0)
    with pytest.raises(FloatingPointError, match="blew up"):
        jsw.simulate_sw(eta0, **kw)
    with pytest.raises(FloatingPointError, match="blew up"):
        sw_solver.simulate_sw(eta0, device="cpu", **kw)


def test_solvers_run_on_the_card_unless_told(monkeypatch):
    """Without a card and without ``device="cpu"`` every entry point
    raises; there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w0 = np.zeros((1, 8, 8), np.float32)
    for call in (lambda: ns2d_solver.simulate_ns2d(w0, n_records=1),
                 lambda: sw_solver.simulate_sw(w0, n_records=1),
                 lambda: generate_ns2d.main(["--out", "x.npz", "--n", "8"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_ns2d_npz_matches_jax_and_loads(tmp_path):
    """``make_ns2d_solver_npz`` writes the JAX function's keys, shapes and
    dtypes, its values within 1e-5 x max|ref|, forward / backward the
    shifts of center; ``NS2DStage1`` reads it."""
    kw = dict(ncase=4, case_len=5, n=16, visc=1e-3, t_record=0.2, dt=1e-3, spinup_records=1,
              seed=2)
    ref_path = jns2d.make_ns2d_solver_npz(str(tmp_path / "j.npz"), **kw)
    path = ns2d_solver.make_ns2d_solver_npz(str(tmp_path / "p" / "p.npz"), device="cpu", **kw)
    with np.load(ref_path) as j, np.load(path) as p:
        assert sorted(p.files) == sorted(j.files) == ["all_sol_backward", "all_sol_center",
                                                      "all_sol_forward"]
        for k in p.files:
            assert p[k].shape == j[k].shape == (5, 16, 16, 4) and p[k].dtype == np.float32
            _close(p[k], j[k], k)
        assert np.array_equal(p["all_sol_center"][1:], p["all_sol_forward"][:-1])
        assert np.array_equal(p["all_sol_center"][:-1], p["all_sol_backward"][1:])
    ds = NS2DStage1(Config(data_dir=path, case_len=5, num_case=4,
                           dataset_stat=str(tmp_path / "stat.npz")))
    batch = ds.get_batch(np.arange(len(ds)))
    assert batch.shape == (len(ds), 16, 16, 1) and np.isfinite(batch).all()


def test_generate_ns2d_cli(tmp_path, capsys):
    """``python -m lns_tpu_torch.cli.generate_ns2d`` at a tiny size with
    ``--device cpu`` writes what ``make_ns2d_solver_npz`` writes, bitwise;
    the flags default as the JAX package's script."""
    out = str(tmp_path / "gen.npz")
    args = ["--out", out, "--ncase", "2", "--case-len", "3", "--n", "16", "--t-record", "0.01",
            "--dt", "2.5e-3", "--spinup", "1", "--seed", "3", "--device", "cpu"]
    assert generate_ns2d.main(args) == out
    assert "wrote" in capsys.readouterr().out
    ref = ns2d_solver.make_ns2d_solver_npz(str(tmp_path / "ref.npz"), ncase=2, case_len=3, n=16,
                                           visc=1e-4, t_record=0.01, seed=3, dt=2.5e-3,
                                           spinup_records=1, device="cpu")
    with np.load(out) as a, np.load(ref) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    proc = subprocess.run([sys.executable, "-m", "lns_tpu_torch.cli.generate_ns2d", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for flag in ("--ncase", "--case-len", "--n", "--visc", "--t-record", "--dt", "--spinup",
                 "--seed", "--device"):
        assert flag in proc.stdout


@pytest.mark.parametrize("fmt", ["zarr", "npz"])
def test_sw_store_matches_jax_and_loads(tmp_path, fmt):
    """``make_sw_solver_store`` writes the JAX function's files: the same
    splits (6 training, 2 test cases), keys, shapes, dtypes and zarr
    chunks, values within 1e-5 x max|ref|, the same normstats keys with
    values within 1e-5 (relative); ``SWStage1`` reads it."""
    kw = dict(ncase=6, case_len=4, h=16, w=32, seed=5, fmt=fmt)
    ref = jsw.make_sw_solver_store(str(tmp_path / "j"), **kw)
    out = sw_solver.make_sw_solver_store(str(tmp_path / "p"), device="cpu", **kw)
    assert [os.path.basename(p) for p in out] == [os.path.basename(p) for p in ref]
    for a, b, n in zip(out[:2], ref[:2], (6, 2)):
        for ch in CHANNELS:
            if fmt == "zarr":
                za, zb = open_zarr(a)[ch], open_zarr(b)[ch]
                with open(os.path.join(a, ch, ".zarray")) as f, \
                        open(os.path.join(b, ch, ".zarray")) as g:
                    meta_a, meta_b = json.load(f), json.load(g)
                assert meta_a == meta_b and meta_a["chunks"] == [1, 4, 16, 32]
                assert sorted(os.listdir(os.path.join(a, ch))) == \
                    sorted(os.listdir(os.path.join(b, ch)))
                xa, xb = za.read_all(), zb.read_all()
            else:
                with np.load(a) as fa, np.load(b) as fb:
                    assert sorted(fa.files) == sorted(fb.files) == ["pres", "u", "v"]
                    xa, xb = fa[ch], fb[ch]
            assert xa.shape == xb.shape == (n, 4, 16, 32) and xa.dtype == xb.dtype == np.float32
            _close(xa, xb, f"{a} {ch}")
    with np.load(out[2]) as sa, np.load(ref[2]) as sb:
        assert sorted(sa.files) == sorted(sb.files) == sorted(
            f"{ch}_{s}" for ch in CHANNELS for s in ("mean", "std"))
        for k in sa.files:
            assert sa[k].dtype == sb[k].dtype == np.float32
            assert abs(float(sa[k]) - float(sb[k])) <= 1e-5 * abs(float(sb[k])) + 1e-9, k
    ds = SWStage1(Config(train_data_dir=out[0], test_data_dir=out[1], dataset_stat=out[2],
                         case_len=4, num_case=6))
    batch = ds.get_batch(np.arange(len(ds)))
    assert batch.shape == (len(ds), 16, 32, 3) and np.isfinite(batch).all()


# -- the data-parallel predict ----------------------------------------------------------

# one rank: argv[1] is a JSON spec (cfg, state, x, cond, steps, rows, init,
# out). It loads the model on the CPU, runs sharded_predict on the global x
# and gather_rows on its rows of `rows`, saves both, and fails if jax or the
# JAX package was imported.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from lns_tpu_torch.config import Config
from lns_tpu_torch.models import LatentDynamics
from lns_tpu_torch.parallel import ddp

spec = json.loads(sys.argv[1])
dev = ddp.init_from_env("cpu", init_method=spec["init"])
r, world = ddp.rank(), ddp.world_size()
model = LatentDynamics(Config(spec["cfg"]), device=dev)
model.load_state_dict(torch.load(spec["state"], weights_only=True), strict=True)
x = torch.from_numpy(np.load(spec["x"]))
cond = None if spec["cond"] is None else torch.from_numpy(np.load(spec["cond"]))
y = ddp.sharded_predict(model.eval(), x, spec["steps"], cond)
rows = torch.from_numpy(np.load(spec["rows"]))
g = ddp.gather_rows(ddp.shard_rows(rows, r, world))
np.save(os.path.join(spec["out"], f"predict{r}.npy"), y.numpy())
np.save(os.path.join(spec["out"], f"rows{r}.npy"), g.numpy())
ddp.shutdown()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lns_tpu"))
if bad:
    raise RuntimeError(f"a rank imported {bad[:5]}")
"""


def _dryrun_ns2d():
    """``dryrun_multichip``'s NS2d configuration (16x16 field, 4x4 latent)."""
    return graft._ns2d_cfg(res=16, latent_res=4).replace(
        encoder_channels=[32, 32, 64, 64], decoder_channels=[64, 64, 32, 32],
        attn_resolutions=[8], attn_heads=4, attn_dim=16, prop_n_block=2, prop_n_embd=32)


FAMILIES = {"NS2d": (_dryrun_ns2d, (16, 16, 1)), "SW": (graft._tiny_hp_cfg, (16, 32, 3)),
            "conditional two-phase": (graft._tiny_cond_cfg, (31, 61, 4))}


def _run_ranks(tmp, spec, world=2, timeout=240):
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, json.dumps(spec)], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
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


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_predict_two_ranks_match_the_jax_mesh(tmp_path, family):
    """Batch 4 (2 per rank), 4 steps, f32, every rank holding the global
    input: on two gloo ranks ``sharded_predict`` gives every rank the same
    global result, within 3e-4 of the JAX predict jitted with
    ``in_shardings=(rep, bsh[, bsh])`` on 2 devices (``dryrun_multichip``'s
    families and shardings) and within 3e-4 of one port process (bitwise
    or not, printed). ``gather_rows`` gives ``make_global_batch``'s rows."""
    make_cfg, shape = FAMILIES[family]
    jcfg = make_cfg()
    d = jcfg.to_dict()
    model = init_weights_(LatentDynamics(Config(d), device="cpu"),
                          torch.Generator().manual_seed(11))
    params = perturb(convert_latent_dynamics(
        jcfg, {k: v.numpy() for k, v in model.state_dict().items()}), 11, 0.02)
    state = state_dict_from_jax(Config(d), params)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4,) + shape).astype(np.float32)
    cond = rng.uniform(0, 1, 4).astype(np.float32) if jcfg.is_conditional else None
    rows = rng.standard_normal((4, 3, 5)).astype(np.float32)

    mesh = data_mesh(jax.devices()[:2])
    rep, bsh = replicated_sharding(mesh), batch_sharding(mesh)
    jm = JLatentDynamics(jcfg)
    if cond is None:
        fn = jax.jit(lambda p, x: jm.predict(p, x, steps=4, to_x=True),
                     in_shardings=(rep, bsh), out_shardings=bsh)
        ref = np.asarray(fn(params, jnp.asarray(x)))
    else:
        fn = jax.jit(lambda p, x, c: jm.predict(p, x, steps=4, cond=c, to_x=True),
                     in_shardings=(rep, bsh, bsh), out_shardings=bsh)
        ref = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(cond)))
    ref_rows = np.asarray(make_global_batch(mesh, rows))

    paths = {k: str(tmp_path / f"{k}.npy") for k in ("x", "cond", "rows")}
    np.save(paths["x"], x)
    np.save(paths["rows"], rows)
    if cond is not None:
        np.save(paths["cond"], cond)
    torch.save(state, str(tmp_path / "state.pt"))
    _run_ranks(tmp_path, dict(cfg=d, state=str(tmp_path / "state.pt"), x=paths["x"],
                              cond=None if cond is None else paths["cond"], steps=4,
                              rows=paths["rows"], out=str(tmp_path),
                              init="file://" + str(tmp_path / "rendezvous")))
    outs = [np.load(tmp_path / f"predict{r}.npy") for r in range(2)]
    assert np.array_equal(outs[0], outs[1])
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"rows{r}.npy"), ref_rows)
    out = outs[0]
    assert out.shape == ref.shape == (4, 4) + shape
    one = load_predict(model, state, x, cond)
    err_jax, err_one = np.abs(out - ref).max(), np.abs(out - one).max()
    print(f"{family}: 2 ranks against the JAX mesh {err_jax:.3e}, against one process "
          f"{err_one:.3e} ({'bitwise equal' if np.array_equal(out, one) else 'not bitwise'})")
    assert err_jax <= 3e-4 and err_one <= 3e-4


def load_predict(model, state, x, cond):
    """One port process's predict of the global batch."""
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        return model.eval().predict(torch.from_numpy(x), 4,
                                    None if cond is None else torch.from_numpy(cond)).numpy()


def test_sharded_predict_at_one_process_is_predict():
    """With no process group ``sharded_predict`` is ``model.predict`` and
    ``gather_rows`` the identity; a batch that does not divide over the
    ranks raises as the mesh does."""
    from lns_tpu_torch.parallel import ddp

    jcfg = _dryrun_ns2d()
    model = init_weights_(LatentDynamics(Config(jcfg.to_dict()), device="cpu"),
                          torch.Generator().manual_seed(1)).eval()
    x = torch.randn(3, 16, 16, 1, generator=torch.Generator().manual_seed(2))
    assert torch.equal(ddp.sharded_predict(model, x, 2, decode_chunk=4),
                       model.predict(x, 2, decode_chunk=4))
    assert ddp.gather_rows(x) is x
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        ddp.shard_rows(x, 0, 2)
