"""The spectral (FNO) layers of the port (``lns_tpu_torch.ops.spectral``,
``ops.fno``, ``ops.fourier_cond``) and the NS2d autoencoder with its
Fourier layers (``final_smoothing``, ``fourier_resolutions``) against the
JAX package, on the CPU.

The same seeded numpy inputs and the JAX parameters (flax init plus
seeded noise, converted by ``lns_tpu_torch.utils.convert``) go through
``lns_tpu`` and ``lns_tpu_torch``. Tolerances: one spectral conv within
1e-5 x max|ref| in f32 (pocketfft under both packages, but another
transform plan and another sum order in the mode contraction); a block
likewise; the autoencoder and ``predict`` 3e-4, the port's bound for its
models (tests/test_torch_export.py:48 holds the JAX AE to the torch
reference so); a stage-1 step's loss rel 1e-5 and its gradients 1e-4 x
max|g| per tensor, as ``tests/test_torch_port_stage1.py`` holds the
autoencoder without Fourier layers. bf16 is held to the *jitted* JAX
functions, with the share of differing elements measured and bounded.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lns_tpu.config import Config as JConfig
from lns_tpu.models import LatentDynamics as JLatentDynamics
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.ops import fno as jfno
from lns_tpu.ops import fourier_cond as jfc
from lns_tpu.ops import spectral as jspectral
from lns_tpu.train import Stage1Trainer as JStage1Trainer
from lns_tpu.utils.torch_export import export_autoencoder
from lns_tpu_torch.config import Config, ns2d_config
from lns_tpu_torch.models import LatentDynamics, SimpleAutoencoder
from lns_tpu_torch.models.specs import decoder_spec, encoder_spec
from lns_tpu_torch.ops import fno, fourier_cond, spectral
from lns_tpu_torch.train import stage1
from lns_tpu_torch.utils import msgpack
from lns_tpu_torch.utils.convert import state_dict_from_jax, state_dict_to_jax

from _torch_port import load, perturb, small_ns2d_dict, to_np


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cf(x: np.ndarray) -> torch.Tensor:
    """Channels-last numpy [B, ..., C] -> the port's channel-first view of
    the same memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def _cl(t: torch.Tensor) -> np.ndarray:
    return t.movedim(1, -1).detach().float().numpy()


def _pair(jm, module, x, seed=1, scale=0.02, *args):
    """The JAX module's parameters (flax init + seeded noise) loaded into
    `module` through the block table; returns (params, module)."""
    jargs = [jnp.asarray(a) for a in (x,) + args]
    params = perturb(jm.init(jax.random.PRNGKey(seed), *jargs)["params"], seed, scale)
    return params, load(module, state_dict_from_jax(None, params, kind=module))


def _close(out, ref, rel):
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max())


# -- the spectral convs ---------------------------------------------------------------

_CONVS = {
    "1d": ((2, 64, 8), (10,)),
    "2d": ((2, 16, 16, 8), (5, 4)),
    "2d-odd": ((2, 61, 121, 4), (10, 20)),  # odd sides: irfft2 must take s=(h, w)
    "2d-overlap": ((2, 10, 12, 4), (6, 5)),  # 2 m1 > h: the bottom block wins
    "3d": ((2, 8, 6, 10, 4), (3, 2, 4)),
}


@pytest.mark.parametrize("case", list(_CONVS))
def test_spectral_conv_matches_jax(case):
    shape, modes = _CONVS[case]
    c, o = shape[-1], 6
    jm = {1: jspectral.SpectralConv1d, 2: jspectral.SpectralConv2d,
          3: jspectral.SpectralConv3d}[len(modes)](c, o, *modes)
    x = _x(shape, 3)
    params, m = _pair(jm, spectral.spectral(c, o, modes), x, scale=0.05)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = _cl(m(_cf(x)))
    assert out.shape == ref.shape == shape[:-1] + (o,)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("n,m", [(1024, 16), (64, 33), (63, 32), (9, 3)],
                         ids=["n1024", "nyquist", "odd-n", "short"])
def test_irfft_modes_is_the_truncated_irfft(n, m):
    """``irfft_modes`` (the 1D conv's synthesis by matmul, which steps round
    cuFFT's batched 1D c2r fault on the card) equals ``torch.fft.irfft`` of
    the zero-padded spectrum within 1e-6 x max|ref|, the Nyquist column
    (n even, m - 1 = n / 2) counted once and the imaginary parts of k = 0
    and Nyquist dropped."""
    z = torch.complex(torch.randn(3, m, 5, generator=torch.Generator().manual_seed(n)),
                      torch.randn(3, m, 5, generator=torch.Generator().manual_seed(m)))
    full = torch.zeros(3, n // 2 + 1, 5, dtype=torch.complex64)
    full[:, :m] = z
    ref = torch.fft.irfft(full, n=n, dim=1)
    _close(spectral.irfft_modes(z, n).numpy(), ref.numpy(), 1e-6)


@pytest.mark.parametrize("hw,modes", [((16, 16), (4, 9)), ((12, 15), (3, 5)), ((16, 16), (5, 6))],
                         ids=["nyquist", "odd-w", "even-w"])
def test_dft_form_matches_jax_and_the_fft_form(hw, modes):
    """``SpectralConv2d(use_dft_matmul=True)`` against the JAX DFT form and
    the port's FFT form (1e-5 x max|ref|), the Nyquist column counted once
    where the last retained column is W / 2."""
    x = _x((2,) + hw + (4,), 4)
    jm = jspectral.SpectralConv2d(4, 5, *modes, use_dft_matmul=True)
    params, m = _pair(jm, spectral.SpectralConv2d(4, 5, *modes, use_dft_matmul=True), x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = _cl(m(_cf(x)))
        m.use_dft_matmul = False
        fft = _cl(m(_cf(x)))
    _close(out, ref, 1e-5)
    _close(out, fft, 1e-5)


def test_modes_wider_than_the_rfft_raise_in_both_packages():
    """At 8x8 six modes meet five rfft columns: the JAX einsum fails, and
    the port raises rather than pad."""
    x = _x((1, 8, 8, 4), 5)
    jm = jspectral.SpectralConv2d(4, 4, 6, 6)
    with pytest.raises(Exception):
        jax.eval_shape(lambda: jm.init_with_output(jax.random.PRNGKey(0), jnp.asarray(x)))
    with pytest.raises(ValueError, match="exceed"):
        spectral.SpectralConv2d(4, 4, 6, 6)(_cf(x))
    with pytest.raises(ValueError, match="exceed"):
        spectral.SpectralConv1d(4, 4, 6)(torch.zeros(1, 4, 8))


# -- the FNO blocks ---------------------------------------------------------------

@pytest.mark.parametrize("modes,residual", [((6, 6), True), ((4, 3), False), ((5,), True),
                                            ((2, 3, 2), True)],
                         ids=["2d", "2d-no-residual", "1d", "3d"])
def test_fourier_basic_block_matches_jax(modes, residual):
    shape = (2,) + (16, 12, 8)[:len(modes)] + (8,)
    x = _x(shape, 6)
    jm = jfno.FourierBasicBlock(8, 8, modes, residual=residual)
    params, m = _pair(jm, fno.FourierBasicBlock(8, 8, modes, residual=residual), x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        _close(_cl(m(_cf(x))), ref, 1e-5)


# the share of elements differing from the jitted JAX block in bf16, at most
# what was measured: 0 at 16x16 c16 and 32x32 c16; at 64x64 c64 (path 6's
# decoder head) 12 of 524,288 elements one bf16 ulp away (the FFT's sums in
# another order), so 5.7e-6; the bound leaves the measurement twice its room
_FBB_BF16 = {(16, 16, 16, (6, 6)): 0.0, (32, 32, 16, (6, 6)): 0.0,
             (64, 64, 64, (16, 16)): 1.2e-5}


@pytest.mark.parametrize("h,w,c,modes", list(_FBB_BF16))
def test_fourier_basic_block_bf16_matches_jitted_jax(h, w, c, modes):
    """The bf16 block rounds where the jitted JAX block does: the spectral
    conv's f32 result rounded to bf16, the 1x1 bypass in bf16, their bf16
    sum, the port's bf16 GELU and the residual (XLA keeps nothing of this
    chain unrounded: the f32 sum before the GELU differs on 14 %)."""
    x = _x((2, h, w, c), 7)
    jm = jfno.FourierBasicBlock(c, c, modes)
    params, m = _pair(jm, fno.FourierBasicBlock(c, c, modes), x)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    with torch.no_grad():
        out = _cl(m(_cf(x).to(torch.bfloat16)))
    share = float((out != ref).mean())
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    assert share <= _FBB_BF16[(h, w, c, modes)], f"{share:.3e} of the elements differ"


@pytest.mark.parametrize("norm,out_ch", [("in", 8), ("ln", 8), ("none", 12)])
def test_mixer_blocks_match_jax(norm, out_ch):
    """``ResFNOMixerBlock`` (its ``ln`` GroupNorm(1) through kernel 3's plain
    version) and, where the widths agree, ``CondResFNOMixerBlock`` (its
    gate's second layer taken off zero by the noise), 1e-5 x max|ref|."""
    x, v = _x((2, 16, 16, 8), 8), _x((2, 8), 9)
    jm = jfno.ResFNOMixerBlock(8, out_ch, (5, 5), norm=norm)
    params, m = _pair(jm, fno.ResFNOMixerBlock(8, out_ch, (5, 5), norm=norm), x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        _close(_cl(m(_cf(x))), ref, 1e-5)
    if out_ch != 8:
        return
    jm = jfno.CondResFNOMixerBlock(8, out_ch, (5, 5), norm=norm)
    params, m = _pair(jm, fno.CondResFNOMixerBlock(8, out_ch, (5, 5), norm=norm), x, 2, 0.05, v)
    assert np.abs(params["cond_fc2"]["kernel"]).max() > 0
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(v)))
    with torch.no_grad():
        _close(_cl(m(_cf(x), torch.from_numpy(v))), ref, 1e-5)


def test_cond_mixer_of_two_widths_fails_in_both_packages():
    """``CondResFNOMixerBlock`` with ``in_channels != out_channels`` cannot
    run in the JAX package: its gate is ``in_channels`` wide and scales the
    token mixer's ``out_channels`` (lns_tpu/ops/fno.py:94-105). The port
    keeps the JAX block's function and fails there too (ROADMAP Queue 3)."""
    x, v = _x((2, 16, 16, 8), 8), _x((2, 8), 9)
    jm = jfno.CondResFNOMixerBlock(8, 12, (5, 5))
    with pytest.raises(TypeError, match="broadcasting"):
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(v))
    with pytest.raises(RuntimeError, match="size of tensor"):
        fno.CondResFNOMixerBlock(8, 12, (5, 5))(_cf(x), torch.from_numpy(v))


def test_conditional_fourier_layers_match_jax():
    """``FreqLinear`` (its (m1, m2, bank, re/im) reading of the product),
    ``CondSpectralConv2d`` and ``CondFourierBasicBlock`` (bf16 input: the
    f32 vector promotes the sum, as in JAX), 1e-5 x max|ref| (bf16 2e-2)."""
    v = _x((3, 8), 10)
    jm = jfc.FreqLinear(8, 4, 3)
    params, m = _pair(jm, fourier_cond.FreqLinear(8, 4, 3), v, 3, 0.1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(v)))
    out = m(torch.from_numpy(v)).detach().numpy()
    assert out.shape == ref.shape == (3, 4, 3, 2)
    _close(out, ref, 1e-6)

    x = _x((3, 16, 12, 8), 11)
    jm = jfc.CondSpectralConv2d(8, 6, 8, 4, 3)
    params, m = _pair(jm, fourier_cond.CondSpectralConv2d(8, 6, 8, 4, 3), x, 4, 0.1, v)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(v)))
    with torch.no_grad():
        _close(_cl(m(_cf(x), torch.from_numpy(v))), ref, 1e-5)

    jm = jfc.CondFourierBasicBlock(8, 8, (4, 3))
    params, m = _pair(jm, fourier_cond.CondFourierBasicBlock(8, 8, (4, 3)), x, 5, 0.1, v)
    for dt, jdt, rel in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2e-2)):
        ref = jax.jit(lambda p, x, v: jm.apply({"params": p}, x, v))(
            params, jnp.asarray(x, jdt), jnp.asarray(v))
        with torch.no_grad():
            out = m(_cf(x).to(dt), torch.from_numpy(v))
        assert out.dtype == torch.float32  # the f32 vector promotes the block
        _close(_cl(out), np.asarray(ref, np.float32), rel)


# -- path 6: the NS2d autoencoder with its Fourier layers -------------------------------------

def _fourier_dict():
    """The test model with both switches: FourierBasicBlocks at the
    encoder's 32x32 and 16x16 levels (modes 6x6) and the decoder's 32x32
    head (modes 16x16; 2 x 16 rows meet at the 32 rows without overlap)."""
    return {**small_ns2d_dict(), "final_smoothing": True, "fourier_resolutions": [32, 16]}


@pytest.fixture(scope="module")
def path6():
    d = _fourier_dict()
    jmodel = JLatentDynamics(JConfig(d))
    params = perturb(jax.jit(lambda k: jmodel.init(k, (1, 32, 32, 1)))(jax.random.PRNGKey(6))
                     ["params"], 6, 0.02)
    model = load(LatentDynamics(Config(d), device="cpu"), state_dict_from_jax(Config(d), params))
    return d, jmodel, params, model, _x((3, 32, 32, 1), 12)


def test_fourier_layer_specs_build():
    """Every spec kind builds, the Fourier layers at the widths and modes
    the JAX specs give (path 6 at full size: 64x64 c64 modes 10, 32x32 c64
    modes 6, the decoder head 64x64 c64 modes 16)."""
    cfg = ns2d_config().replace(final_smoothing=True, fourier_resolutions=[64, 32])
    ae = SimpleAutoencoder(cfg)
    found = [(part, type(ae_part.model[s.idx].fourier).__name__, s.kw["modes"])
             for part, ae_part, specs in (("encoder", ae.encoder, encoder_spec(cfg)),
                                          ("decoder", ae.decoder, decoder_spec(cfg)))
             for s in specs if s.kind == "fourier"]
    assert found == [("encoder", "SpectralConv2d", (10, 10)), ("encoder", "SpectralConv2d", (6, 6)),
                     ("decoder", "SpectralConv2d", (16, 16))]


def test_fourier_autoencoder_and_predict_match_jax(path6):
    """The AE's encode and decode, and ``predict`` (3 steps, decode chunks
    of 4: the last padded) with the kernels (their plain versions here) and
    without, 3e-4."""
    d, jmodel, params, model, x = path6
    ref = np.asarray(jmodel.predict({"params": params}, jnp.asarray(x), 3, decode_chunk=4,
                                    use_pallas=False))
    assert ref.shape == (3, 3, 32, 32, 1)
    for flag in (True, False):
        out = model.use_kernels(flag).predict(torch.from_numpy(x), 3, decode_chunk=4)
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-4, err_msg=f"kernels={flag}")
    model.use_kernels(True)


def test_fourier_stage1_step_matches_jax_grad(path6):
    """``stage1.reconstruction_loss`` and its gradients against
    ``jax.value_and_grad`` of the JAX trainer's loss (f32): loss rel 1e-5,
    every gradient within 1e-4 x max|g| of the JAX one; the spectral banks'
    gradients (through ``torch.fft``) among them and nonzero."""
    d, _, params, _, x = path6
    jcfg = JConfig(d)
    ae_params = params["vq_ae"]
    host = types.SimpleNamespace(model=JSimpleAutoencoder(jcfg), loss_on_denorm=False)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, xx: JStage1Trainer._loss(host, p, xx)))(ae_params, jnp.asarray(x))
    ref = {k: np.asarray(v, np.float32) for k, v in export_autoencoder(jcfg, to_np(grads_j)).items()}
    model = load(SimpleAutoencoder(Config(d)), state_dict_from_jax(Config(d), ae_params, "ae"))
    loss = stage1.reconstruction_loss(model, torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads.keys() == {k for k in ref if not k.endswith("inv_freq")}  # buffers
    top = max(np.abs(g).max() for g in ref.values())
    spectral_keys = [k for k in grads if ".fourier.weights" in k]
    assert len(spectral_keys) == 6
    for k, g in grads.items():
        scale = np.abs(ref[k]).max()
        if scale <= 1e-6 * top:  # a bias that a GroupNorm(32) subtracts again
            assert np.abs(g).max() <= 1e-6 * top, k
            continue
        np.testing.assert_allclose(g, ref[k], atol=1e-4 * scale, err_msg=k)
    assert all(np.abs(grads[k]).max() > 0 for k in spectral_keys)


def test_fourier_model_converts_both_ways_bitwise(path6):
    """``state_dict_from_jax`` -> ``state_dict_to_jax`` gives the JAX tree
    back bitwise, and so does the flax msgpack written and read by the
    port's own reader; the stage-1 ``ae`` kind likewise; the Fourier keys
    are ``torch_export``'s."""
    d, _, params, model, _ = path6
    cfg = Config(d)
    for kind, tree in (("dynamics", params), ("ae", params["vq_ae"])):
        state = state_dict_from_jax(cfg, tree, kind)
        back = state_dict_to_jax(cfg, state, kind)
        again = state_dict_from_jax(cfg, msgpack.unpackb(msgpack.packb(back)), kind)
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for key in path:
                node = node[key.key]
            assert np.array_equal(node, np.asarray(leaf)), path
        for k, v in state.items():
            assert torch.equal(again[k], v), k
    state = state_dict_from_jax(cfg, params)
    assert "vq_ae.decoder.model.14.fourier.weights2" in state
    assert "vq_ae.encoder.model.4.conv.weight" in state
    assert tuple(state["vq_ae.encoder.model.4.fourier.weights1"].shape) == (32, 32, 6, 6, 2)


def test_fourier_stage1_trainers_side_by_side(tmp_path, monkeypatch):
    """``Stage1Trainer`` on path 6's model at test size against the JAX
    trainer, one f32 epoch on one synthetic corpus (10 cases x 6 frames of
    32x32, batch 8: 7 steps), from the same parameters: the first step's
    loss within rel 1e-5, every step's and the validation losses within rel
    1e-3. The model without Fourier layers holds 1e-4 over the same epoch
    (``tests/test_torch_port_stage1.py``); here the spectral banks' weights
    (U(0, 1 / (in out)), ~2.4e-4 at 64 channels, ~1e-3 at 32) are of the
    size of one Adam step (lr 5e-4), which moves an element whose gradient
    is near zero by about lr x its sign, so sum-order residues in the
    gradients (held per tensor to 1e-4 x max|g| above) carry into the
    losses: measured at most 2.5e-4 at step 7."""
    import json
    import os

    from lns_tpu.train import stage1 as jstage1
    from lns_tpu_torch.data import synthetic

    d = _fourier_dict()
    d.update(data_dir=synthetic.make_ns2d_npz(str(tmp_path / "ns2d.npz"), ncase=10, case_len=6,
                                              h=32, w=32),
             case_len=6, num_case=10, dataset_stat=None, batch_size=8, epochs=1,
             learning_rate=5e-4, ckpt_every=1, overwrite_exist=True)
    jcfg = JConfig(d)
    jae = JSimpleAutoencoder(jcfg)
    x0 = jnp.zeros((1, 32, 32, 1))
    params = perturb(jax.jit(lambda k: jae.init(k, x0))(jax.random.PRNGKey(7))["params"], 7, 0.02)
    for mod in (jstage1, stage1):
        monkeypatch.setattr(mod, "log_sequence", lambda *a: None)
        monkeypatch.setattr(mod, "plot_error_curve", lambda *a: None)
    monkeypatch.setattr(JSimpleAutoencoder, "init", lambda self, key, x: {"params": params})
    jt = JStage1Trainer(JConfig(d, log_dir=str(tmp_path / "jlog")), seed=5, use_wandb=False)
    pt = stage1.Stage1Trainer(Config(d, log_dir=str(tmp_path / "plog")), seed=5,
                              use_wandb=False, device="cpu")
    pt.model.load_state_dict(state_dict_from_jax(Config(d), params, "ae"), strict=True)
    jt.train()
    pt.train()

    def metrics(log_dir, key):
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            return [r[key] for r in map(json.loads, f) if key in r]

    for key, n in (("rec_loss", 7), ("val_recon_loss", 2)):
        jl, pl = metrics(jt.cfg.log_dir, key), metrics(pt.cfg.log_dir, key)
        assert len(jl) == len(pl) == n, key
        np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(pl, jl, rtol=1e-3, err_msg=key)
