"""The port's entry points around training, on the CPU, against the JAX
package where it has a counterpart: ``lns_tpu_torch.cli.evaluate`` against
``lns_tpu.cli.evaluate``, the flax msgpack reader and writer
(``lns_tpu_torch.utils.msgpack``) against ``flax.serialization`` and the
``msgpack`` package, ``lns_tpu_torch.cli.convert`` against
``lns_tpu.cli.convert`` in both directions, ``KM2DStage1/2`` against the
JAX classes; then the port alone: evaluate of a trained checkpoint against
the trainer's own validation, the side-stream prefetch's order on the CPU,
background checkpoints, and ``torchrun`` of a training CLI on two gloo
ranks from an SW YAML. f32; each tolerance is stated where it is used.
"""

import json
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack as msgpack_ref
import numpy as np
import pytest
import torch
import yaml

from lns_tpu.cli import convert as jconvert
from lns_tpu.cli import evaluate as jevaluate
from lns_tpu.config import Config as JConfig
from lns_tpu.data.km2d import KM2DStage1 as JKM2DStage1
from lns_tpu.data.km2d import KM2DStage2 as JKM2DStage2
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.train.checkpoint import save_pytree
from lns_tpu.utils.torch_export import (export_autoencoder, export_latent_dynamics,
                                        save_torch_checkpoint)
from lns_tpu_torch.cli import convert, evaluate
from lns_tpu_torch.config import (Config, ns2d_config, sw_config, twophase_conditional_config,
                                  twophase_config)
from lns_tpu_torch.data import KM2DStage1, KM2DStage2
from lns_tpu_torch.data.prefetch import prefetch_to_device
from lns_tpu_torch.data.synthetic import make_sw_store
from lns_tpu_torch.models import LatentDynamics, SimpleAutoencoder
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.train import checkpoint, stage2
from lns_tpu_torch.utils import msgpack
from lns_tpu_torch.utils.convert import key_table, state_dict_from_jax, state_dict_to_jax

from test_torch_port_ddp import REPO, _metrics, _ns2d_cfg, _stage2_start

import __graft_entry__ as graft


def _yaml(path, d):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


@pytest.fixture(scope="module")
def ns2d(tmp_path_factory):
    """The test-size NS2d model on its synthetic corpus: the JAX parameter
    tree, the config's YAML, and the model as a ``torch_export`` ``.pt``,
    a flax ``.msgpack`` (``save_pytree``) and the AE alone as a ``.pt``."""
    tmp = str(tmp_path_factory.mktemp("ns2d"))
    d = _ns2d_cfg(tmp, log_dir=os.path.join(tmp, "log"))
    params, _ = _stage2_start(tmp, d, seed=31)
    jcfg = JConfig(d)
    paths = dict(pt=os.path.join(tmp, "model.pt"), msgpack=os.path.join(tmp, "model.msgpack"),
                 ae=d["pretrained_checkpoint_path"], yaml=_yaml(os.path.join(tmp, "c.yml"), d))
    save_torch_checkpoint(export_latent_dynamics(jcfg, params), paths["pt"])
    save_pytree(params, paths["msgpack"])
    return d, params, paths


# -- evaluate ---------------------------------------------------------------------

def test_evaluate_matches_the_jax_cli(ns2d, tmp_path, monkeypatch):
    """``lns_tpu_torch.cli.evaluate.main`` on the ``torch_export`` ``.pt``
    and on the flax ``.msgpack`` of one JAX parameter tree: the JAX CLI's
    metric keys; both files score bitwise alike; every value within rel
    1e-4 of ``lns_tpu.cli.evaluate.main`` on the ``.pt`` (f32 on the CPU,
    sums in another order)."""
    d, _, paths = ns2d
    jout = str(tmp_path / "j.json")
    monkeypatch.setattr(sys, "argv", ["evaluate", "--config", paths["yaml"], "--checkpoint",
                                      paths["pt"], "--out", jout])
    jevaluate.main()
    with open(jout) as f:
        ref = json.load(f)
    out = {}
    for kind in ("pt", "msgpack"):
        pout = str(tmp_path / f"p_{kind}.json")
        evaluate.main(["--config", paths["yaml"], "--checkpoint", paths[kind], "--device", "cpu",
                       "--out", pout])
        with open(pout) as f:
            out[kind] = json.load(f)
    assert out["pt"] == out["msgpack"]
    assert out["pt"].keys() == ref.keys() == {"rollout_steps", "num_trajectories",
                                               "seq_rel_l2_per_channel", "seq_rel_l2",
                                               "frame_rel_l2_vs_time"}
    for k, v in ref.items():
        np.testing.assert_allclose(out["pt"][k], v, rtol=1e-4, err_msg=k)


def test_evaluate_of_model_best_is_the_trainers_validation(tmp_path, monkeypatch):
    """A port trainer's ``model_best.pt`` scored by ``evaluate_checkpoint``
    gives ``meta_best.json``'s ``val_seq_rel_l2`` exactly (one scoring
    function, ``stage2.rollout_errors``, on the same weights), and the
    report carries that record as ``training_best_checkpoint``."""
    monkeypatch.setattr(stage2, "log_sequence", lambda *a: None)
    monkeypatch.setattr(stage2, "plot_error_curve", lambda *a: None)
    d = _ns2d_cfg(str(tmp_path), log_dir=str(tmp_path / "log"), epochs=2)
    t = stage2.Stage2Trainer(Config(d), seed=7, use_wandb=False, device="cpu")
    t.train()
    ckpt = os.path.join(d["log_dir"], "checkpoints")
    metrics = evaluate.evaluate_checkpoint(Config(d), os.path.join(ckpt, "model_best.pt"),
                                           device="cpu")
    best = checkpoint.load_json(os.path.join(ckpt, "meta_best.json"))
    assert metrics["seq_rel_l2"] == best["val_seq_rel_l2"] == t.best_val
    assert metrics["training_best_checkpoint"] == best
    assert metrics["num_trajectories"] == len(t.val_ds)


# -- msgpack --------------------------------------------------------------------------

def _flax_tree(rng):
    """Leaves of every kind flax writes: arrays of several dtypes and
    shapes (0-d, empty, > 64 KiB), bf16, numpy scalars, Python scalars,
    str, bytes and None, a list (flax writes it as a map)."""
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "big": rng.standard_normal((130, 130)).astype(np.float32),
        "nest": {"i32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
                 "bf16": np.asarray(jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)),
                 "f16": rng.standard_normal(7).astype(np.float16),
                 "u8": np.arange(5, dtype=np.uint8), "b": np.array([True, False]),
                 "zero_d": np.array(2.5, np.float64), "empty": np.zeros((0, 3), np.float32)},
        "np_scalar": np.float32(1.25), "np_int": np.int64(-7), "np_bool": np.bool_(True),
        "py": [1, -200, 70000, 2 ** 40, 3.5, "text", b"raw", None, True],
    }


def _same_leaf(ours, ref):
    if isinstance(ours, torch.Tensor):  # bf16: the raw bits
        assert ours.dtype == torch.bfloat16 and ref.dtype.name == "bfloat16"
        assert tuple(ours.shape) == ref.shape
        assert np.array_equal(ours.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(ours) is type(ref) and ours.dtype == ref.dtype and ours.shape == ref.shape
        assert ours.tobytes() == ref.tobytes()
    else:
        assert type(ours) is type(ref) and ours == ref


def _same_tree(ours, ref):
    if isinstance(ref, dict):
        assert list(ours) == list(ref)
        for k in ref:
            _same_tree(ours[k], ref[k])
    else:
        _same_leaf(ours, ref)


def test_msgpack_reads_and_writes_flax_bytes():
    """``unpackb`` of ``flax.serialization.to_bytes`` gives ``msgpack_restore``'s
    tree (arrays bitwise with their dtypes, bf16 as a ``torch.bfloat16``
    tensor of the same bits, numpy scalars as scalars); ``packb`` of that
    tree gives flax's bytes exactly, which ``msgpack_restore`` reads back."""
    tree = _flax_tree(np.random.default_rng(41))
    data = flax.serialization.to_bytes(tree)
    ref = flax.serialization.msgpack_restore(data)
    ours = msgpack.unpackb(data)
    _same_tree(ours, ref)
    assert msgpack.packb(ours) == data
    _same_tree(flax.serialization.msgpack_restore(msgpack.packb(ours)), ref)


CONTAINERS = {
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32,
             -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "floats": [0.0, -1.5, 1e300, float("inf")],
    "strs": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "b" * 70000, "é中"],
    "bins": [b"", b"x" * 255, b"x" * 256, b"y" * 70000],
    "lists": [list(range(15)), list(range(16)), list(range(70000)), []],
    "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {str(i): None for i in range(70000)}, {}],
    "consts": [None, True, False],
}


@pytest.mark.parametrize("kind", sorted(CONTAINERS))
def test_msgpack_matches_the_msgpack_package(kind):
    """Each size class of int, float, str, bin, array and map: ``packb``
    gives ``msgpack.packb(use_bin_type=True)``'s bytes, and ``unpackb``
    reads them as ``msgpack.unpackb(raw=False)`` does."""
    obj = {kind: CONTAINERS[kind]}
    data = msgpack_ref.packb(obj, use_bin_type=True)
    assert msgpack.packb(obj) == data
    assert msgpack.unpackb(data) == msgpack_ref.unpackb(data, raw=False)


def test_msgpack_refuses_other_ext_types_and_bad_data():
    """An ext type flax does not write for arrays (2, a complex number)
    raises naming it; so do trailing and truncated bytes."""
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.unpackb(flax.serialization.to_bytes({"c": 1 + 2j}))
    data = msgpack.packb({"a": np.arange(3)})
    with pytest.raises(ValueError, match="after the object"):
        msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        msgpack.unpackb(data[:-2])


# -- convert ----------------------------------------------------------------------------

def test_convert_matches_the_jax_cli(ns2d, tmp_path, monkeypatch):
    """Both kinds, both directions, against ``lns_tpu.cli.convert.main``:
    ``.pt -> .msgpack`` writes the JAX CLI's bytes exactly (the same tree,
    keys sorted as ``save_pytree`` writes them); ``.msgpack -> .pt`` writes
    its keys and tensors, bitwise."""
    d, params, paths = ns2d
    with monkeypatch.context() as mp:  # the JAX CLI's templates, without a flax init
        mp.setattr(JLatentDynamics, "init", lambda self, key, shape: {"params": params})
        mp.setattr(JSimpleAutoencoder, "init", lambda self, key, x: {"params": params["vq_ae"]})
        for kind, src in (("ae", paths["ae"]), ("dynamics", paths["pt"])):
            outs = {}
            for who in ("jax", "port"):
                mp_out = str(tmp_path / f"{who}_{kind}.msgpack")
                pt_out = str(tmp_path / f"{who}_{kind}.pt")
                for a, b in ((src, mp_out), (str(tmp_path / f"jax_{kind}.msgpack"), pt_out)):
                    argv = ["--config", paths["yaml"], "--input", a, "--output", b,
                            "--kind", kind]
                    if who == "jax":
                        mp.setattr(sys, "argv", ["convert"] + argv)
                        jconvert.main()
                    else:
                        convert.main(argv)
                outs[who] = mp_out, pt_out
            with open(outs["jax"][0], "rb") as f, open(outs["port"][0], "rb") as g:
                assert f.read() == g.read(), kind
            a, b = (torch.load(outs[w][1], weights_only=True) for w in ("jax", "port"))
            assert a.keys() == b.keys()
            assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a), kind


def test_convert_reads_bf16_msgpack_bitwise(ns2d, tmp_path):
    """A flax msgpack of the tree cast to bf16: ``convert`` writes a ``.pt``
    whose tensors are those bf16 values widened to f32, exactly."""
    d, params, paths = ns2d
    bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    src = tmp_path / "bf16.msgpack"
    src.write_bytes(flax.serialization.to_bytes(bf16))
    convert.main(["--config", paths["yaml"], "--input", str(src), "--output",
                  str(tmp_path / "bf16.pt"), "--kind", "dynamics"])
    out = torch.load(tmp_path / "bf16.pt", weights_only=True)
    ref = state_dict_from_jax(Config(d), jax.tree.map(lambda a: a.astype(np.float32), bf16))
    assert out.keys() == ref.keys() and all(torch.equal(out[k], ref[k]) for k in ref)


@pytest.mark.parametrize("name", ["hp", "cond"])
def test_inverse_gives_the_jax_tree(name):
    """``state_dict_to_jax`` of the ``torch_export`` state dict of a JAX
    tree (``jax.jit`` init, seeded noise) at the SW and conditional
    two-phase test sizes is that tree: the same paths and arrays, bitwise."""
    jcfg = graft._tiny_hp_cfg() if name == "hp" else graft._tiny_cond_cfg()
    model = JLatentDynamics(jcfg)
    shape = (1, *jcfg.resolutions, jcfg.in_channels)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: model.init(k, shape))(
        jax.random.PRNGKey(4))["params"])
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_latent_dynamics(jcfg, params).items()}
    tree = state_dict_to_jax(Config(jcfg.to_dict()), sd)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        assert a.shape == b.shape and np.array_equal(a, b)


FULL = {"ns2d": ns2d_config, "ns2d_attn_enc": lambda: ns2d_config().replace(use_attn_enc=True),
        "sw": sw_config, "twophase": twophase_config,
        "twophase_conditional": twophase_conditional_config}


@pytest.mark.parametrize("name", sorted(FULL))
def test_round_trip_at_full_width(name, tmp_path):
    """``.pt -> .msgpack -> .pt`` through ``convert`` at each family's full
    width, for the stage-2 model and the stage-1 AE, gives back every
    parameter bitwise. The rotary frequencies, a constant the JAX tree does
    not hold, come back as ``torch_export`` computes them (numpy), within
    1e-6 of the module's own buffer (torch's ``pow``)."""
    cfg = FULL[name]()
    model = init_weights_(LatentDynamics(cfg, device="cpu"), torch.Generator().manual_seed(5))
    ae = init_weights_(SimpleAutoencoder(cfg), torch.Generator().manual_seed(6))
    for kind, sd in (("dynamics", model.state_dict()), ("ae", ae.state_dict())):
        src, mid, back = (str(tmp_path / f"{kind}.{e}") for e in ("pt", "msgpack", "back.pt"))
        torch.save(sd, src)
        convert.convert(cfg, src, mid, kind)
        convert.convert(cfg, mid, back, kind)
        out = torch.load(back, weights_only=True)
        assert out.keys() == sd.keys(), kind
        rotary = {e.key: e for e in key_table(cfg, kind) if e.path is None}
        for k, v in sd.items():
            if k in rotary:
                dim = rotary[k].dim
                ref = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
                assert np.array_equal(out[k].numpy(), ref), (kind, k)
                np.testing.assert_allclose(out[k].numpy(), v.numpy(), rtol=1e-6)
            else:
                assert torch.equal(out[k], v), (kind, k)


# -- KM2D -----------------------------------------------------------------------------

def _parts(v):
    return v if isinstance(v, tuple) else (v,)


def test_km2d_datasets_match_jax(tmp_path):
    """``KM2DStage1`` / ``KM2DStage2`` on a small ``.npy`` (4 sequences of 5
    frames of 256x256, strided to 32x32) equal the JAX classes bitwise: the
    data, statistics (computed, then read from the file they wrote), train
    frames by index and by seeded random slot, eval trajectories, the
    encoded corpus and its windows."""
    path = str(tmp_path / "km.npy")
    np.save(path, np.random.default_rng(51).standard_normal((4, 5, 256, 256)).astype(np.float32))
    d = dict(data_dir=path, resolution=32, case_len=5, train_num=2, test_num=2, out_tw=2,
             interval=1, dataset_stat=str(tmp_path / "km_stat.npz"))
    encode = lambda x: x[:, ::4, ::4] * 2.0  # noqa: E731
    for train_mode in (True, False):
        for pc, jc in ((KM2DStage1, JKM2DStage1), (KM2DStage2, JKM2DStage2)):
            p, j = pc(Config(d), train_mode), jc(JConfig(d), train_mode)
            assert np.array_equal(p.data, j.data) and len(p) == len(j)
            assert all(np.array_equal(p.stats[k], j.stats[k]) for k in j.stats)
            for a, b in zip(_parts(p.eval_trajectories()), _parts(j.eval_trajectories())):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            if not train_mode:
                continue
            idx = np.arange(len(p))
            if pc is KM2DStage2:
                p.encode_dataset(encode, batch=3)
                j.encode_dataset(encode, batch=3)
                assert np.array_equal(p.encoded, j.encoded)
            for rng in (None, 7):
                pb = p.get_batch(idx, None if rng is None else np.random.default_rng(rng))
                jb = j.get_batch(idx, None if rng is None else np.random.default_rng(rng))
                for a, b in zip(_parts(pb), _parts(jb)):
                    assert a.dtype == b.dtype and np.array_equal(a, b)


# -- prefetch and background saves ------------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_the_order(size):
    """On the CPU ``prefetch_to_device`` yields each host batch's arrays as
    tensors, in order, whatever `size`."""
    rng = np.random.default_rng(61)
    batches = [(rng.standard_normal((2, 3)).astype(np.float32), np.arange(i, i + 2))
               for i in range(4)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=size))
    assert len(out) == len(batches)
    for got, want in zip(out, batches):
        assert all(isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), a)
                   for t, a in zip(got, want))
    assert list(prefetch_to_device(iter([]), "cpu", size=size)) == []


def test_async_checkpointer_round_trip(tmp_path):
    """``AsyncCheckpointer.save`` writes a copy taken when it is called (the
    tensors changed in place right after are not what lands on disk), and
    ``wait`` returns once the file is there; a save that fails raises at
    ``wait``."""
    ck = checkpoint.AsyncCheckpointer()
    state = {"w": torch.arange(6.0).reshape(2, 3), "opt": {"step": torch.tensor(3), "n": 1}}
    want = {"w": state["w"].clone(), "opt": {"step": torch.tensor(3), "n": 1}}
    path = str(tmp_path / "a.pt")
    ck.save(state, path)
    state["w"].add_(1.0)
    state["opt"]["step"].add_(1)
    ck.wait()
    got = torch.load(path, weights_only=True)
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["opt"]["step"],
                                                            want["opt"]["step"])
    assert got["opt"]["n"] == 1 and not os.path.exists(path + ".tmp")
    ck.save(state, str(tmp_path / "missing" / "b.pt"))
    with pytest.raises(RuntimeError, match="does not exist"):
        ck.wait()


def test_async_checkpoint_trainer_writes_the_same_files(tmp_path, monkeypatch):
    """A stage-2 trainer with ``async_checkpoint`` writes the files of one
    without it, bitwise (the model, optimizer and best checkpoints)."""
    monkeypatch.setattr(stage2, "log_sequence", lambda *a: None)
    monkeypatch.setattr(stage2, "plot_error_curve", lambda *a: None)
    dirs = {}
    for flag in (False, True):
        d = _ns2d_cfg(str(tmp_path / str(flag)), log_dir=str(tmp_path / str(flag) / "log"),
                      async_checkpoint=flag)
        t = stage2.Stage2Trainer(Config(d), seed=7, use_wandb=False, device="cpu")
        assert (t._ckptr is not None) == flag
        t.train()
        dirs[flag] = os.path.join(d["log_dir"], "checkpoints")
    names = sorted(f for f in os.listdir(dirs[False]) if f.endswith(".pt"))
    assert names == sorted(f for f in os.listdir(dirs[True]) if f.endswith(".pt"))
    assert {"model_0.pt", "optim_0.pt", "model_best.pt", "model_final.pt"} <= set(names)
    for f in names:
        a, b = (torch.load(os.path.join(dirs[k], f), weights_only=True) for k in (False, True))
        flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(flat_a) == len(flat_b) and jax.tree.structure(a) == jax.tree.structure(b)
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(flat_a, flat_b)), f


# -- torchrun ---------------------------------------------------------------------------

def test_torchrun_trains_an_sw_yaml_on_two_cpu_ranks(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m lns_tpu_torch.cli.
    train_stage1 --config <yml> --device cpu --no-wandb`` from a YAML
    written from ``sw_config()`` (full width, f32) on a synthetic 96x192
    corpus (2 training cases, 2 frames each after the skipped first two):
    one epoch of one step of the global batch 4 (2 per rank), the run
    directory, metrics and final checkpoints written once, both ranks
    finishing."""
    data = str(tmp_path / "sw")
    make_sw_store(data, ncase=2, case_len=4, h=96, w=192, seed=0)
    d = sw_config().replace(
        train_data_dir=os.path.join(data, "train.zarr"),
        test_data_dir=os.path.join(data, "test.zarr"),
        dataset_stat=os.path.join(data, "normstats.npz"), case_len=4, num_case=2, batch_size=4,
        epochs=1, learning_rate=3e-5, ckpt_every=9, log_dir=str(tmp_path / "log"),
        overwrite_exist=True).to_dict()
    cfg_path = _yaml(tmp_path / "sw_stage1.yml", d)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "lns_tpu_torch.cli.train_stage1", "--config", cfg_path, "--device", "cpu",
         "--no-wandb"], env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert proc.stdout.count("Running finished...") == 2
    log = d["log_dir"]
    assert len(_metrics(log, "rec_loss")) == 1 and len(_metrics(log, "val_recon_loss")) == 2
    assert all(np.isfinite(_metrics(log, "rec_loss")))
    for f in ("config.yaml", "checkpoints/vqgan_epoch_final.pt",
              "checkpoints/optim_epoch_final.pt", "checkpoints/vqgan_epoch_best.pt"):
        assert os.path.exists(os.path.join(log, f)), f
