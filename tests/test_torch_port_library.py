"""The port's remaining library blocks against the JAX package, on the CPU:
``CondResidualBlock`` and ``embed_sequential`` (``ops.conditioning``), the
conditional encoder and its autoencoder (``CondEncoder``,
``ConditionalSimpleAutoencoder``), ``LABlock`` and ``CABlock``, ``Sine``,
``Siren``, ``SirenNet`` and ``EmbeddingWrapper``, the library propagators
``SimpleResNet``, ``SimpleMLP`` and ``ConditionalResNet``, their
initialisation and their conversion both ways.

The same seeded numpy inputs and JAX parameters (flax init plus seeded
noise, converted by ``lns_tpu_torch.utils.convert``) go through ``lns_tpu``
and ``lns_tpu_torch``. Tolerances: a block 1e-5 x max|ref| in f32 (2e-5
for a propagator, the bound of the SimpleCNN step in
``tests/test_torch_port_models.py``), the conditional autoencoder 3e-4
(the port's bound for its autoencoders) and its gradients 1e-4 x max|g|
per tensor (as ``tests/test_torch_port_stage1.py``); bf16 against the
*jitted* JAX blocks with the share of differing elements measured and
bounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lns_tpu.config import Config as JConfig
from lns_tpu.models import ConditionalSimpleAutoencoder as JCondAE
from lns_tpu.models import propagator as jprop
from lns_tpu.ops import attention as jattn
from lns_tpu.ops import conditioning as jcond
from lns_tpu.ops import embedding as jemb
from lns_tpu.ops.activations import swish as jswish
from lns_tpu.utils.torch_compat import convert_cond_encoder
from lns_tpu.utils.torch_export import export_sequential
from lns_tpu_torch.config import Config, twophase_conditional_config
from lns_tpu_torch.models.specs import decoder_spec
from lns_tpu_torch.models import (ConditionalResNet, ConditionalSimpleAutoencoder, SimpleMLP,
                                  SimpleResNet)
from lns_tpu_torch.ops import attention, conditioning, embedding, fno, fourier_cond, spectral
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.utils import msgpack
from lns_tpu_torch.utils.convert import state_dict_from_jax, state_dict_to_jax

from _torch_port import load, perturb, to_np


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cf(x):
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def _cl(t):
    return t.movedim(1, -1).detach().float().numpy()


def _pair(jm, module, args, seed=1, scale=0.05):
    """The JAX module's parameters (flax init on `args` + seeded noise)
    loaded into `module` through its block table."""
    params = perturb(jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args))["params"],
                     seed, scale)
    return params, load(module, state_dict_from_jax(None, params, kind=module))


def _close(out, ref, rel):
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max())


def _same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _round_trips(cfg, params, kind):
    """JAX tree -> state dict -> JAX tree and -> flax msgpack (the port's
    writer and reader) -> state dict, each bitwise."""
    state = state_dict_from_jax(cfg, params, kind)
    back = state_dict_to_jax(cfg, state, kind)
    _same_tree(back, to_np(params))
    again = state_dict_from_jax(cfg, msgpack.unpackb(msgpack.packb(back)), kind)
    assert again.keys() == state.keys()
    assert all(torch.equal(again[k], v) for k, v in state.items())
    return state


# -- CondResidualBlock and embed_sequential -----------------------------------------------

# bf16 against the jitted JAX block: the share of differing elements
# measured at these inputs, 5, 6, 7, 33 and 5 elements of 29,760 (59,520 at
# 64 channels), one bf16 ulp each: f32 sums in another order, and without
# the norms the f32 GELU of torch against XLA's, an ulp apart, rounded to
# bf16 by conv2. Before the rounding points were placed (conv1's sum
# unrounded, norm2's ``h sc`` rounded and ``+ sh`` not) the scale-shift
# forms differed on 30 % and 35 %.
_CRB = {("add", True, 32, 32): 1.7e-4, ("add", True, 32, 64): 1.01e-4,
        ("scale-shift", True, 32, 32): 2.36e-4, ("add", False, 32, 32): 1.11e-3,
        ("scale-shift", False, 32, 64): 8.5e-5}


@pytest.mark.parametrize("form,norm,cin,cout", list(_CRB))
def test_cond_residual_block_matches_jax(form, norm, cin, cout):
    """f32 within 1e-5 x max|ref|; bf16 against the jitted JAX block within
    1e-2 x max|ref| and ``_CRB``'s share."""
    ss = form == "scale-shift"
    x, e = _x((2, 15, 31, cin), 0), _x((2, 16), 1)
    kw = dict(norm=norm, use_scale_shift_norm=ss)
    jm = jcond.CondResidualBlock(cin, cout, 16, **kw)
    params, m = _pair(jm, conditioning.CondResidualBlock(cin, cout, 16, **kw), (x, e))
    assert np.abs(params["conv2"]["kernel"]).max() > 0  # the zero gate opened by the noise
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(e)))
    with torch.no_grad():
        _close(_cl(m(_cf(x), torch.from_numpy(e))), ref, 1e-5)
    jb = jcond.CondResidualBlock(cin, cout, 16, dtype=jnp.bfloat16, **kw)
    ref = jax.jit(lambda p, x, e: jb.apply({"params": p}, x, e))(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e))
    ref = np.asarray(ref.astype(jnp.float32))
    mb = load(conditioning.CondResidualBlock(cin, cout, 16, dtype=torch.bfloat16, **kw),
              m.state_dict())
    with torch.no_grad():
        out = _cl(mb(_cf(x).to(torch.bfloat16), torch.from_numpy(e)))
    share = float((out != ref).mean())
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    assert share <= _CRB[(form, norm, cin, cout)], f"{share:.3e} differ"


def test_cond_residual_block_scale_shift_gradient():
    """The bf16 scale-shift block's norm2 takes its value from kernel 3's
    coefficients and its gradient through kernel 3's output (the two differ
    by that output's last rounding): every parameter and the input get a
    finite gradient within 2e-2 x max|g| of the f32 block's, norm2's and
    conv1's among them."""
    x, e = _x((2, 9, 11, 32), 2), torch.from_numpy(_x((2, 16), 3))
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        m = init_weights_(conditioning.CondResidualBlock(32, 32, 16, norm=True,
                                                         use_scale_shift_norm=True, dtype=dt),
                          torch.Generator().manual_seed(4))
        with torch.no_grad():
            m.conv2.weight.normal_(std=0.05, generator=torch.Generator().manual_seed(5))
            m.norm2.weight.normal_(1.0, 0.2, generator=torch.Generator().manual_seed(6))
        xt = _cf(x).to(dt).requires_grad_()
        m(xt, e).float().square().mean().backward()
        grads[dt] = {"x": xt.grad.float(), **{k: p.grad for k, p in m.named_parameters()}}
    for k, g32 in grads[torch.float32].items():
        g16, scale = grads[torch.bfloat16][k], g32.abs().max().item()
        assert scale > 0 and torch.isfinite(g16).all(), k
        assert (g16 - g32).abs().max().item() <= 2e-2 * scale, k


def test_embed_sequential_routes_the_vector():
    """Layers that take two inputs get the vector, the others not."""
    x, e = torch.from_numpy(_x((2, 8, 6, 6), 4)), torch.from_numpy(_x((2, 8), 5))
    block = init_weights_(fourier_cond.CondFourierBasicBlock(8, 8, (3, 2)),
                          torch.Generator().manual_seed(1))
    conv = init_weights_(spectral.SpectralConv2d(8, 8, 3, 2), torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = conditioning.embed_sequential([block, conv, torch.tanh], x, e)
        torch.testing.assert_close(out, torch.tanh(conv(block(x, e))), rtol=0, atol=0)


# -- the conditional encoder and its autoencoder ------------------------------------------

@pytest.fixture(scope="module")
def cond_ae():
    """``ConditionalSimpleAutoencoder`` at ``_tiny_cond_cfg()`` (31x61x4 field,
    7x15x16 latent, encoder widths 32-64, a 16-wide embedding): JAX
    parameters with seeded noise (so conv2 of every block is not zero)."""
    d = graft._tiny_cond_cfg().to_dict()
    jae = JCondAE(JConfig(d))
    x, p = _x((2, 31, 61, 4), 6), np.array([0.2, 0.7], np.float32)
    params = perturb(jax.jit(lambda k: jae.init(k, jnp.asarray(x), jnp.asarray(p)))(
        jax.random.PRNGKey(6))["params"], 6, 0.02)
    return d, jae, params, x, p


def test_conditional_autoencoder_matches_jax(cond_ae):
    """encode(x, param) and decode(z) in f32 within 3e-4; another parameter
    gives another latent."""
    d, jae, params, x, p = cond_ae
    model = load(ConditionalSimpleAutoencoder(Config(d)),
                 state_dict_from_jax(Config(d), params, "cond_ae"))
    z_ref = np.asarray(jae.apply({"params": params}, jnp.asarray(x), jnp.asarray(p),
                                 method="encode"))
    y_ref = np.asarray(jae.apply({"params": params}, jnp.asarray(x), jnp.asarray(p)))
    with torch.no_grad():
        z = model.encode(torch.from_numpy(x), torch.from_numpy(p)).numpy()
        y = model(torch.from_numpy(x), torch.from_numpy(p)).numpy()
        z_other = model.encode(torch.from_numpy(x), torch.from_numpy(1 - p)).numpy()
    assert z.shape == (2, 7, 15, 16) and y.shape == x.shape
    np.testing.assert_allclose(z, z_ref, atol=3e-4)
    np.testing.assert_allclose(y, y_ref, atol=3e-4)
    assert np.abs(z_other - z).max() > 1e-2 * np.abs(z).max()


# the encoder's parts in order: (JAX module, its input's JAX module, swish
# between them)
_ENC_PARTS = [("to_in_conv2", "to_in_conv1", True), ("level0_res0", "to_in_conv2", False),
              ("level0_down", "level0_res0", False), ("level1_res0", "level0_down", False),
              ("level1_down", "level1_res0", False), ("level2_res0", "level1_down", False),
              ("to_out_conv", "level2_res0", False)]


def test_conditional_encoder_bf16_matches_jitted_jax(cond_ae):
    """The bf16 encoder part by part against the jitted JAX encoder's
    captured intermediates: each conv, down-sample and
    ``CondResidualBlock`` fed the JAX part's bf16 input and the JAX
    embedding, within 1e-2 x max|ref| and at most 0.1 % of its elements
    differing (measured at most 0.080 %, ``level1_res0``: sum order); the
    whole encode within 2e-2 x max|ref| (its f32 embedding MLP differs from
    XLA's in the last f32 bit on 75 % of the entries, which moves bf16
    roundings everywhere after it)."""
    d, _, params, x, p = cond_ae
    jae = JCondAE(JConfig(d), dtype=jnp.bfloat16)
    ref, state = jax.jit(lambda prm, x, p: jae.apply({"params": prm}, x, p, method="encode",
                                                      capture_intermediates=True))(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(p))
    inter = {k: v["__call__"][0] for k, v in state["intermediates"]["encoder"].items()
             if k != "__call__"}
    model = load(ConditionalSimpleAutoencoder(Config(d), dtype=torch.bfloat16),
                 state_dict_from_jax(Config(d), params, "cond_ae"))
    enc = model.encoder
    ports = {"to_in_conv2": enc.to_in[2], "level0_res0": enc.layers[0][0][0],
             "level0_down": enc.layers[0][1], "level1_res0": enc.layers[1][0][0],
             "level1_down": enc.layers[1][1], "level2_res0": enc.layers[2][0][0],
             "to_out_conv": enc.to_out_conv}
    emb = torch.from_numpy(np.array(inter["embed_fc2"]))

    def bf16(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).movedim(-1, 1).to(torch.bfloat16)

    with torch.no_grad():
        for name, src, sw in _ENC_PARTS:
            xin = jax.jit(jswish)(inter[src]) if sw else inter[src]
            part = ports[name]
            got = _cl(part(bf16(xin), emb) if isinstance(part, conditioning.CondResidualBlock)
                      else part(bf16(xin)))
            want = np.asarray(inter[name].astype(jnp.float32))
            assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), name
            assert float((got != want).mean()) <= 1e-3, name
        z = model.encode(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(p))
    assert z.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(z.float().numpy(), ref, atol=2e-2 * np.abs(ref).max())


def test_conditional_autoencoder_gradients_match_jax(cond_ae):
    """The reconstruction's mean square and its gradients against
    ``jax.value_and_grad`` (f32): loss rel 1e-5, each gradient within 1e-4
    x max|g| of the JAX gradient (the decoder's conv biases that a
    GroupNorm(32) of one channel per group subtracts again, zero in exact
    arithmetic, within 1e-6 x the largest gradient in both packages)."""
    d, jae, params, x, p = cond_ae

    def jloss(prm):
        return jnp.mean(jnp.square(jae.apply({"params": prm}, jnp.asarray(x), jnp.asarray(p))
                                   - jnp.asarray(x)))

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)
    ref = state_dict_from_jax(Config(d), to_np(grads_j), "cond_ae")
    model = load(ConditionalSimpleAutoencoder(Config(d)),
                 state_dict_from_jax(Config(d), params, "cond_ae"))
    xt = torch.from_numpy(x)
    loss = (model(xt, torch.from_numpy(p)) - xt).square().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    top = max(g.abs().max().item() for g in ref.values())
    for k, prm in model.named_parameters():
        scale = ref[k].abs().max().item()
        if scale <= 1e-6 * top:  # a bias that a GroupNorm(32) subtracts again
            assert prm.grad.abs().max().item() <= 1e-6 * top, k
            continue
        np.testing.assert_allclose(prm.grad.numpy(), ref[k].numpy(), atol=1e-4 * scale,
                                   err_msg=k)


def test_conditional_autoencoder_keys_are_the_references(cond_ae):
    """The port's state dict, read by the JAX package's converter of the
    reference's CondEncoder (``convert_cond_encoder``), gives the JAX
    encoder back bitwise, and its decoder keys are those the JAX exporter
    writes (``export_sequential``); the ``cond_ae`` kind round-trips
    bitwise, also through flax msgpack."""
    d, _, params, _, _ = cond_ae
    cfg = Config(d)
    state = _round_trips(cfg, params, "cond_ae")
    sd = {k: v.numpy() for k, v in state.items()}
    _same_tree(convert_cond_encoder(JConfig(d), {k: v for k, v in sd.items()
                                                 if k.startswith("encoder.")}),
               to_np(params["encoder"]))
    ref = export_sequential(decoder_spec(cfg), params["decoder"], "decoder.model")
    assert {k for k in state if k.startswith("decoder.")} == set(ref)
    assert all(np.array_equal(sd[k], np.asarray(v, np.float32)) for k, v in ref.items())


def test_convert_cli_takes_the_conditional_autoencoder(cond_ae, tmp_path):
    """``lns_tpu_torch.cli.convert`` with ``--kind cond_ae``: the JAX tree's
    flax msgpack -> ``.pt`` (the reference's keys, a strict load into the
    port) -> msgpack, the bytes equal."""
    from lns_tpu_torch.cli import convert as cli_convert
    from lns_tpu_torch.train import checkpoint

    d, _, params, _, _ = cond_ae
    cfg = Config(d)
    src, pt, back = (str(tmp_path / n) for n in ("ae.msgpack", "ae.pt", "back.msgpack"))
    with open(src, "wb") as f:
        f.write(msgpack.packb(cli_convert._sorted(to_np(params))))
    cli_convert.convert(cfg, src, pt, "cond_ae")
    load(ConditionalSimpleAutoencoder(cfg), checkpoint.load_torch_state_dict(pt))
    cli_convert.convert(cfg, pt, back, "cond_ae")
    with open(src, "rb") as a, open(back, "rb") as b:
        assert a.read() == b.read()


def test_conditional_autoencoder_at_full_width_builds():
    """At ``twophase_conditional_config()`` (61x121x4, 7x15x64, a 64-wide
    embedding) the converter's keys and shapes are the port model's own
    (from the JAX init's shapes alone), the zero-initialised conv2 of every
    block stays zero under ``init_weights_``, and a CPU encode gives the
    latent's shape."""
    cfg = twophase_conditional_config()
    jae = JCondAE(JConfig(cfg.to_dict()))
    shapes = jax.eval_shape(lambda: jae.init(jax.random.PRNGKey(0), jnp.zeros((1, 61, 121, 4)),
                                             jnp.zeros((1,))))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    model = init_weights_(ConditionalSimpleAutoencoder(cfg), torch.Generator().manual_seed(9))
    state = state_dict_from_jax(cfg, params, "cond_ae")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    gates = [k for k in state if k.endswith("conv2.weight")]
    assert len(gates) == 5 and all(model.state_dict()[k].abs().max() == 0 for k in gates)
    with torch.no_grad():
        z = model.encode(torch.zeros(1, 61, 121, 4), torch.tensor([0.5]))
    assert z.shape == (1, 7, 15, 64) and torch.isfinite(z).all()


# -- attention -------------------------------------------------------------------------

# bf16 against the jitted JAX blocks, measured: LABlock 0 %, CABlock 0 %
@pytest.mark.parametrize("kind", ["LABlock", "CABlock"])
def test_linear_and_cross_attention_match_jax(kind):
    """f32 within 1e-5 x max|ref| on a 16x12 c32 field (CABlock on 5 context
    tokens of 24), the output in the input's layout; bf16 against the
    jitted JAX block within 1e-2 x max|ref| and bitwise on all but 0.1 %."""
    x, y = _x((2, 16, 12, 32), 7), _x((2, 5, 24), 8)
    if kind == "LABlock":
        jm, m, args = jattn.LABlock(32, 4, 8), attention.LABlock(32, 4, 8), (x,)
    else:
        jm, m, args = jattn.CABlock(32, 24, 4, 8), attention.CABlock(32, 24, 4, 8), (x, y)
    params, m = _pair(jm, m, args, 3, 0.05)
    targs = (_cf(x),) + tuple(torch.from_numpy(a) for a in args[1:])
    for dt, jdt, rel, bound in ((torch.float32, jnp.float32, 1e-5, 1.0),
                                (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-3)):
        ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
            params, *(jnp.asarray(a, jdt) for a in args))
        ref = np.asarray(ref.astype(jnp.float32))
        with torch.no_grad():
            out = _cl(m(*(t.to(dt) for t in targs)))
        assert out.shape == ref.shape == x.shape
        _close(out, ref, rel)
        assert float((out != ref).mean()) <= bound


def test_cross_attention_on_tokens_and_linear_attention_has_no_softmax():
    """CABlock on a token sequence [B, N, C] stays a sequence; LABlock's
    weights are the scaled QK^T as they are (doubling V doubles the
    attention's contribution)."""
    m = init_weights_(attention.CABlock(16, 8, 2, 4), torch.Generator().manual_seed(3))
    out = m(torch.randn(2, 7, 16), torch.randn(2, 3, 8))
    assert out.shape == (2, 7, 16)
    la = init_weights_(attention.LABlock(16, 2, 4), torch.Generator().manual_seed(4))
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        la.to_v.bias.normal_(generator=torch.Generator().manual_seed(5))
        base = la(x) - x
        la.to_v.weight *= 2
        la.to_v.bias *= 2
        torch.testing.assert_close(la(x) - x, 2 * base, rtol=1e-5, atol=1e-6)


# -- SIREN and the context embedder -------------------------------------------------------

def test_siren_stack_and_embedding_wrapper_match_jax():
    """``Siren`` (first layer, w0 30), ``SirenNet`` (min-max over dim 1,
    modulation) and ``EmbeddingWrapper`` with a SIREN, a table and a linear
    key ([B, 3, d]; [B, 1, d] for one key), f32 within 1e-5 x max|ref|."""
    x = np.random.default_rng(9).uniform(-1, 1, (4, 3)).astype(np.float32)
    jm = jemb.Siren(3, 8, w0=30.0, is_first=True)
    params, m = _pair(jm, embedding.Siren(3, 8, w0=30.0, is_first=True), (x,), 4, 0.01)
    _close(m(torch.from_numpy(x)).detach().numpy(),
           np.asarray(jm.apply({"params": params}, jnp.asarray(x))), 1e-5)
    assert torch.equal(embedding.Sine(2.0)(torch.ones(2)), torch.sin(torch.full((2,), 2.0)))

    xs, mods = _x((4, 6, 3), 10), _x((4, 6, 16), 11)
    jm = jemb.SirenNet(3, 16, 5, 3)
    params, m = _pair(jm, embedding.SirenNet(3, 16, 5, 3), (xs, mods), 5, 0.01)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(xs), jnp.asarray(mods)))
    _close(m(torch.from_numpy(xs), torch.from_numpy(mods)).detach().numpy(), ref, 1e-5)

    settings = [dict(encoder="siren", in_channels=2, hidden_channels=16, out_channels=8,
                     num_layers=2),
                dict(encoder="embedding", in_channels=1, num_embeddings=5, out_channels=8),
                dict(encoder="linear", in_channels=3, out_channels=8)]
    keys = ["coef_emb", "case_emb", "vel_emb"]
    ctx = {"coef": np.random.default_rng(12).uniform(-1, 1, (4, 1, 2)).astype(np.float32),
           "case": np.array([[0], [3], [4], [1]], np.float32), "vel": _x((4, 3), 13)}
    for n in (3, 1):
        jm = jemb.EmbeddingWrapper(keys[:n], settings[:n])
        m = embedding.EmbeddingWrapper(keys[:n], settings[:n])
        params = perturb(jm.init(jax.random.PRNGKey(7), {k: jnp.asarray(v)
                                                         for k, v in ctx.items()})["params"],
                         7, 0.01)
        load(m, state_dict_from_jax(None, params, kind=m))
        ref = np.asarray(jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in ctx.items()}))
        out = m({k: torch.from_numpy(v) for k, v in ctx.items()}).detach().numpy()
        assert out.shape == ref.shape == (4, n, 8)
        _close(out, ref, 1e-5)


# -- the library propagators ---------------------------------------------------------------

def _propagators():
    """(name, JAX module, port module, inputs) on an 8x8x16 latent, width
    64 (the NS2d latent, narrowed), a context of 4 tokens x 16."""
    z, ctx = _x((2, 8, 8, 16), 14), _x((2, 4, 16), 15)
    return [("SimpleResNet", jprop.SimpleResNet(16, 64), SimpleResNet(16, 64), (z,)),
            ("SimpleResNet zeros", jprop.SimpleResNet(16, 64, is_periodic=False),
             SimpleResNet(16, 64, is_periodic=False), (z,)),
            ("SimpleMLP", jprop.SimpleMLP(16, 8, 64), SimpleMLP(16, 8, 64), (z,)),
            ("ConditionalResNet", jprop.ConditionalResNet(16, 64, 16, n_blocks=2, heads=4,
                                                         dim_head=16),
             ConditionalResNet(16, 64, 16, n_blocks=2, heads=4, dim_head=16), (z, ctx)),
            ("ConditionalResNet no self-attention",
             jprop.ConditionalResNet(16, 64, 16, n_blocks=1, heads=4, dim_head=16,
                                     use_self_attn=False),
             ConditionalResNet(16, 64, 16, n_blocks=1, heads=4, dim_head=16,
                               use_self_attn=False), (z, ctx))]


@pytest.mark.parametrize("i", range(5), ids=[p[0] for p in _propagators()])
def test_library_propagator_matches_jax_and_converts(i):
    """NHWC latents in and out, f32 within 2e-5 x max|ref|; the parameters
    back to the JAX tree and through flax msgpack, bitwise."""
    _, jm, m, args = _propagators()[i]
    params, m = _pair(jm, m, args, 6, 0.02)
    ref = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    with torch.no_grad():
        out = m(*map(torch.from_numpy, args)).numpy()
    assert out.shape == ref.shape == args[0].shape
    _close(out, ref, 2e-5)
    _round_trips(None, params, m)


def test_simple_mlp_flattens_in_hwc_order():
    """A latent that differs in one (h, w, c) entry moves fc1's input at
    index (h W + w) C + c, the JAX package's order."""
    m = init_weights_(SimpleMLP(4, 3, 8), torch.Generator().manual_seed(1))
    seen = []
    m.fc1.register_forward_pre_hook(lambda mod, a: seen.append(a[0].clone()))
    z = torch.zeros(1, 3, 3, 4)
    m(z)
    z[0, 1, 2, 3] = 1.0
    m(z)
    assert torch.nonzero(seen[1] - seen[0])[:, -1].tolist() == [(1 * 3 + 2) * 4 + 3]


# -- initialisation --------------------------------------------------------------------------

def test_init_weights_draws_the_new_distributions():
    """``init_weights_`` (seeded): spectral banks U(0, 1 / (in out)),
    ``FreqLinear`` 1 / (in + 4 m1 m2) N(0, 1) with a zero bias, SIREN layers
    within their bound (1 / fan_in first, sqrt(6 / fan_in) / w0 after),
    ``SirenNet``'s last layer N(0, 0.02) with a zero bias, embedding tables
    N(0, 1), LABlock's projections N(0, 0.02), every zero-initialised gate
    zero; the same seed, the same values."""
    g = torch.Generator().manual_seed(0)
    conv = init_weights_(spectral.SpectralConv2d(16, 32, 8, 8), g)
    w = torch.cat([conv.weights1.flatten(), conv.weights2.flatten()])
    assert w.min() >= 0 and w.max() <= 1 / 512 and abs(w.mean().item() - 1 / 1024) < 2e-5
    fl = init_weights_(fourier_cond.FreqLinear(64, 8, 8), g)
    assert abs(fl.weights.std().item() * (64 + 256) - 1) < 0.02 and fl.bias.abs().max() == 0
    net = init_weights_(embedding.SirenNet(3, 64, 8, 3), g)
    assert net.siren_0.weight.abs().max() <= 1 / 3 and net.siren_0.weight.abs().max() > 0.3
    assert net.siren_1.weight.abs().max() <= (6 / 64) ** 0.5 / 1.0
    assert net.siren_1.bias.abs().max() <= (6 / 64) ** 0.5
    assert abs(net.last_layer.weight.std().item() - 0.02) < 0.004
    assert net.last_layer.bias.abs().max() == 0
    wrap = init_weights_(embedding.EmbeddingWrapper(
        ["c_emb"], [dict(encoder="embedding", in_channels=1, num_embeddings=200,
                         out_channels=64)]), g)
    assert abs(wrap.c_emb.std().item() - 1) < 0.02
    la = init_weights_(attention.LABlock(64, 4, 16), g)
    assert abs(la.to_q.weight.std().item() - 0.02) < 0.002 and la.to_v.bias.abs().max() == 0
    mixer = init_weights_(fno.CondResFNOMixerBlock(16, 16, (4, 4)), g)
    block = init_weights_(conditioning.CondResidualBlock(16, 32, 8), g)
    assert mixer.cond_fc2.weight.abs().max() == 0 and block.conv2.weight.abs().max() == 0
    assert block.conv1.weight.abs().max() > 0
    again = init_weights_(spectral.SpectralConv2d(16, 32, 8, 8), torch.Generator().manual_seed(0))
    assert torch.equal(again.weights1, conv.weights1)
