"""The port's bf16 (and f16) rounding against the JAX package's, on the CPU.

The main path runs the autoencoder in bf16. XLA rounds a bf16 elementwise
chain at points of its own: under ``jax.jit`` it keeps some intermediates of
a fusion in f32 and rounds others, so each form below was measured against
the jitted JAX function, not read off its HLO. Each test reports the share
of elements that differ and states its bound:

  * GELU, swish and the SABlock's softmax: bitwise equal (0 % differ) on
    200,000 seeded values (before the repair, ``F.gelu`` in bf16 differed on
    24.7 % of them, the softmax on 56 %);
  * the upsampling 3x3 conv: bitwise equal (the JAX package sums the
    box-convolved 4x4 taps in bf16; the materialised upsample + 3x3 conv
    differed on 45 %);
  * the d-space FAB core (``_batched_core``): plain version and kernel path
    within 1e-2 x max|ref| with at most 1 % of elements differing (measured
    0 % at the test model, 0.71 % at path 2's class, where the (n, d) = 512
    term out-projection sums in another order; the former kernel path,
    normalising before the projection, differed on 65 %);
  * the autoencoder layer by layer: each layer kind's share at most the
    share measured at the repair (sum-order effects, ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lns_tpu.ops as jops
from lns_tpu.config import Config as JConfig
from lns_tpu.models import SimpleAutoencoder as JSimpleAutoencoder
from lns_tpu.models.autoencoder import resize_nearest_torch
from lns_tpu.ops.activations import gelu as jgelu
from lns_tpu.ops.activations import swish as jswish
from lns_tpu.ops.conv import ConvND as JConvND
from lns_tpu.ops.norms import LayerNorm as JLayerNorm
from lns_tpu_torch.config import Config
from lns_tpu_torch.kernels import axial
from lns_tpu_torch.models import SimpleAutoencoder
from lns_tpu_torch.models.specs import LayerSpec
from lns_tpu_torch.ops import activations, attention, conv, norms
from lns_tpu_torch.ops import factorized_attention as tfa
from lns_tpu_torch.utils.convert import sequential_state_dict

from _torch_port import load, nchw, nhwc, perturb, small_ns2d_dict

_DT = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}


def _share(out, ref):
    return float((np.asarray(out) != np.asarray(ref)).mean())


def _np(t):
    return t.float().numpy()


def _values(n=200_000, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 3).astype(np.float32)


@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_gelu_matches_jax(dt):
    """0 % of 200,000 values N(0, 3^2) differ from ``lns_tpu``'s jitted
    GELU (erfc flushed to 0 below f32's normal range, as XLA on the CPU)."""
    tdt, jdt = _DT[dt]
    x = _values()
    ref = np.asarray(jax.jit(jgelu)(jnp.asarray(x, jdt)).astype(jnp.float32))
    out = activations.gelu(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    share = _share(_np(out), ref)
    assert share == 0.0, f"{share:.4%} of the elements differ (bound 0 %)"
    layer = activations.GELU()(torch.from_numpy(x[:1000]).to(tdt))
    assert torch.equal(layer, out[:1000])


@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_swish_matches_jax(dt):
    """0 % of 200,000 values differ from ``lns_tpu``'s jitted swish; the
    GroupNorm kernel's plain version computes its swish with it."""
    tdt, jdt = _DT[dt]
    x = _values(seed=1)
    ref = np.asarray(jax.jit(jswish)(jnp.asarray(x, jdt)).astype(jnp.float32))
    share = _share(_np(activations.swish(torch.from_numpy(x).to(tdt))), ref)
    assert share == 0.0, f"{share:.4%} of the elements differ (bound 0 %)"


@pytest.mark.parametrize("dim_head", [16, 32, 64])
def test_softmax_matches_jax(dim_head):
    """The SABlock's ``softmax(q k^T * dim_head^-0.5)`` in bf16: 0 % of
    200,704 attention weights differ from the jitted JAX expression (the
    scale a bf16 constant: dim_head 32's is not a power of two)."""
    rng = np.random.default_rng(dim_head)
    q, k = (rng.standard_normal((4, 4, 112, dim_head)).astype(np.float32) for _ in range(2))
    bf = jnp.bfloat16

    def jfn(q, k):
        return jax.nn.softmax(jnp.einsum("bhid,bhjd->bhij", q, k) * (dim_head ** -0.5), axis=-1)

    ref = np.asarray(jax.jit(jfn)(jnp.asarray(q, bf), jnp.asarray(k, bf)).astype(jnp.float32))
    a = torch.einsum("bhid,bhjd->bhij", *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k)))
    out = attention.softmax_last(a, dim_head ** -0.5)
    share = _share(_np(out), ref)
    assert share == 0.0, f"{share:.4%} of the elements differ (bound 0 %)"


@pytest.mark.parametrize("mode", ["circular", "zeros"])
def test_upsample_conv_bf16_matches_jax(mode):
    """nearest-2x + 3x3 conv in bf16, as ``lns_tpu.ops.conv._up2x_conv``
    lowers it: 0 % of the elements differ."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    jm = JConvND(48, 3, padding=1, padding_mode=mode, upsample_2x=True, dtype=jnp.bfloat16)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 7)
    ref = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        p, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    m = conv.ConvND(32, 48, 3, padding=1, padding_mode=mode, upsample_2x=True,
                    dtype=torch.bfloat16)
    m = load(m, {"weight": torch.from_numpy(p["kernel"]).permute(3, 2, 0, 1),
                 "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        out = nhwc(m(nchw(x).to(torch.bfloat16)))
    assert out.shape == ref.shape
    share = _share(out, ref)
    assert share == 0.0, f"{share:.4%} of the elements differ (bound 0 %)"


def test_layer_norm_bf16_matches_jax():
    """LayerNorm in bf16 (f32 statistics, one rounding): 0 % differ."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((4, 64, 128)) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(128) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.1).astype(np.float32)
    ref = JLayerNorm(128).apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                                jnp.asarray(x, jnp.bfloat16))
    ln = load(norms.LayerNorm(128), {"weight": torch.from_numpy(scale),
                                      "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        out = ln(torch.from_numpy(x).to(torch.bfloat16))
    share = _share(_np(out), np.asarray(ref.astype(jnp.float32)))
    assert share == 0.0, f"{share:.4%} of the elements differ (bound 0 %)"


def _dspace_inputs(b, n, h, w, c, d, seed=27):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (f(b, h, w, c), f(b, n, h, h, scale=1 / h), f(b, n, w, w, scale=1 / w),
            f(c, n, d, scale=c ** -0.5), f(n, d, c, scale=d ** -0.5))


# the test model's FAB (dim 32, dim_head 16, 4 heads) and path 2's class
_DSPACE = [(2, 4, 8, 16, 32, 16), (2, 8, 16, 16, 128, 64)]


@pytest.mark.parametrize("b,n,h,w,c,d", _DSPACE)
def test_dspace_core_bf16_rounds_as_batched_core(b, n, h, w, c, d):
    """bf16 in, bf16 out: ``fab_dspace_core_plain`` and ``fab_dspace_core``
    (kernel 4's plain version with its statistics output on the CPU) round
    phi, both applies, wp and the bias where ``_batched_core`` does (jitted,
    as the JAX models run). Bound: 1e-2 x max|ref| and at most 1 % of the
    elements (measured 0 % and 0.71 %)."""
    u, kx, ky, w_in, w_o1 = _dspace_inputs(b, n, h, w, c, d)
    bf = jnp.bfloat16
    ref = jax.jit(jops.FABlock2D._batched_core)(
        *(jnp.asarray(a, bf) for a in (u, kx, ky, w_in)), jnp.asarray(w_o1))
    ref = np.asarray(ref.astype(jnp.float32))
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (u, kx, ky, w_in)]
    for name, fn in (("plain", tfa.fab_dspace_core_plain), ("kernel path", tfa.fab_dspace_core)):
        out = fn(*args, torch.from_numpy(w_o1))
        assert out.dtype == torch.bfloat16 and out.shape == (b, h, w, c)
        out = _np(out)
        err, share = np.abs(out - ref).max() / np.abs(ref).max(), _share(out, ref)
        assert err <= 1e-2 and share <= 0.01, \
            f"{name}: max_err {err:.2e} x max|ref| (<= 1e-2), {share:.4%} differ (<= 1 %)"


@pytest.mark.parametrize("b,n,h,w,c,d", _DSPACE)
def test_axial_stats_plain_matches_batched_core_moments(b, n, h, w, c, d):
    """Kernel 4's statistics output (its plain version, ``stats=True``):
    from ``_batched_core``'s own bf16 x, sum / n and the sum of f32 squares
    / n against its mean and sq. Bound: 1e-6 x max|x| (mean) and
    1e-6 x max|x|^2 (sq): f32 sums of the same values in another order."""
    u, kx, ky, w_in, _ = _dspace_inputs(b, n, h, w, c, d)
    bf = jnp.bfloat16

    def moments(u, kx, ky, w_in):  # the first lines of _batched_core
        phi = jnp.einsum("bhwc,cnd->bhwnd", u, w_in)
        x = jnp.einsum("bnih,bhwnd->bniwd", kx, phi)
        x = jnp.einsum("bnlw,bniwd->bnlid", ky, x)
        return (x, jnp.mean(x, axis=(2, 3), dtype=jnp.float32),
                jnp.mean(jnp.square(x.astype(jnp.float32)), axis=(2, 3)))

    x, mean, sq = jax.jit(moments)(*(jnp.asarray(a, bf) for a in (u, kx, ky, w_in)))
    x = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    stats = axial.axial_stats_plain(x)  # x is [b, n, w, h, d]: the sums do not mind
    assert stats.shape == (b, n, d, 2) and stats.dtype == torch.float32
    scale = float(x.float().abs().max())
    for name, got, want, ref_scale in (("mean", stats[..., 0], mean, scale),
                                       ("sq", stats[..., 1], sq, scale ** 2)):
        err = np.abs(got.numpy() / (h * w) - np.asarray(want)).max() / ref_scale
        assert err <= 1e-6, f"{name}: max_err {err:.2e} x max|x|^k (<= 1e-6)"
    # the wrapper on a CPU tensor returns the plain version's output and stats
    tkx, tky, phi = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (kx, ky, np.asarray(jnp.einsum(
                         "bhwc,cnd->bnhwd", jnp.asarray(u, bf), jnp.asarray(w_in, bf)
                     ).astype(jnp.float32))))
    y, st = axial.fab_axial_in_fused(tkx, tky, phi, with_instance_norm=False, stats=True)
    assert torch.equal(y, axial.fab_axial_in_plain(tkx, tky, phi, with_instance_norm=False))
    assert torch.equal(st, axial.axial_stats_plain(y))
    # heads last ([b, h, w, n, d], the d-space core's layout): the same values
    y2, st2 = axial.fab_axial_in_fused(tkx, tky, phi.permute(0, 2, 3, 1, 4),
                                       with_instance_norm=False, stats=True, heads_last=True)
    assert torch.equal(y2, y.permute(0, 2, 3, 1, 4)) and torch.equal(st2, st)


# The c-space FAB block (``_fab_impl_for``: 5 dim < 9 dim_head) in bf16, per
# (dim, dim_head, heads, h, w): the share of elements that differ from the
# jitted JAX block, at most what was measured once the block read what XLA
# feeds ``_batched_gram_core`` (mean_c from the GroupNorm(1) output before
# its bf16 round and from the f32 kernel products before theirs; LayerNorm
# dividing by sqrt(var + eps); the pooled mean a sum times 1/count; the
# rotary positions and inv_freq as the jitted package computes them).
# Before: 26.9 %, 29.4 %, 27.0 % and 42.8 %. The residue at SW's class
# comes from one element of the y kernel's to_qk product (1 of 98,304; a
# 64-term bf16 product summed in another order), which moves 5 of 9,216
# elements of K_y and through them a whole row and column of the output
# (with the JAX K_y fed in, 0.49 %; ROADMAP Queue 3).
_CSPACE = {(32, 32, 4, 16, 16): 0.0, (32, 32, 4, 8, 16): 0.0, (32, 32, 4, 16, 8): 0.00025,
           (64, 64, 8, 12, 24): 0.038}


@pytest.mark.parametrize("dim,dim_head,heads,h,w", list(_CSPACE))
def test_cspace_fab_block_bf16_matches_jitted_jax(dim, dim_head, heads, h, w):
    """The port's bf16 ``FABlock2D`` (c-space core, on the CPU its plain
    version) against the jitted ``lns_tpu.ops.FABlock2D`` on the same
    converted weights (flax init, ``perturb`` seed 2; input
    ``default_rng(28)``, batch 2): the largest error at most 1e-2 x max|ref|
    and the share of differing elements at most ``_CSPACE``'s."""
    jm = jops.FABlock2D(dim, dim_head, dim_head, heads, dim, dtype=jnp.bfloat16)
    x = np.random.default_rng(28).standard_normal((2, h, w, dim)).astype(np.float32)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    spec = LayerSpec(0, "fablock", tuple(sorted(dict(
        dim=dim, dim_head=dim_head, latent_dim=dim_head, heads=heads, dim_out=dim).items())))
    state = sequential_state_dict([spec], {spec.name: p}, "")  # keys "0.{name}"
    block = load(tfa.FABlock2D(dim, dim_head, dim_head, heads, dim),
                 {k[len("0."):]: v for k, v in state.items()})
    assert block.impl == "batchedgram"
    with torch.no_grad():
        out = nhwc(block(nchw(x).to(torch.bfloat16)))
    err, share = np.abs(out - ref).max() / np.abs(ref).max(), _share(out, ref)
    bound = _CSPACE[(dim, dim_head, heads, h, w)]
    assert err <= 1e-2 and share <= bound, \
        f"max_err {err:.2e} x max|ref| (<= 1e-2), {share:.4%} differ (<= {bound:.4%})"


# Per layer kind: the share of elements differing, at most what
# test_autoencoder_bf16_per_layer_kind measured once the rounding faults were
# repaired (every layer fed the JAX layer's own bf16 input): conv 1 of
# 225,792 elements, resblock 87 of 120,832, FAB 191 of 45,056 (all in the
# encoder's 8x8 c64 block: 2.3 % of its elements), upsample+conv 1 of 90,112,
# each within one bf16 ulp of max|ref|. What remains is f32 sums taken in
# another order (a value near a rounding boundary lands one ulp away and
# carries through the layer; ROADMAP Queue 3). Before the repairs: FAB 0.42 %
# (the same), SABlock 4.2 % (softmax), upsample+conv 45 % (the 4x4 taps).
_AE_BOUNDS = {"conv": 5e-6, "swish": 0.0, "resblock": 0.00073, "GN+swish": 0.0,
              "SABlock": 0.0, "FAB": 0.0043, "upsample+conv": 1.2e-5, "upsample": 0.0}


def _kind(specs, i):
    s = specs[i]
    if s.kind == "gn":
        return "GN+swish" if i + 1 < len(specs) and specs[i + 1].kind == "swish" else "GN"
    if s.kind == "conv" and s.kw.get("upsample_2x") or s.kind == "up":
        return "upsample+conv"
    return {"down": "conv", "resize": "upsample", "sablock": "SABlock",
            "fablock": "FAB"}.get(s.kind, s.kind)


def _per_layer_kind(d, bounds):
    """The bf16 autoencoder of config dict `d` layer by layer against
    ``lns_tpu``'s bf16 AE on the same converted weights: each port layer,
    through a forward pre-hook, takes the jitted JAX layer's bf16 input, and
    a forward hook compares its output with the JAX layer's. Per layer
    kind: the largest error at most 1e-2 x max|ref| and the share of
    differing elements at most `bounds`' (every kind of `bounds` met)."""
    jae = JSimpleAutoencoder(JConfig(d), dtype=jnp.bfloat16)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 1)).astype(np.float32)
    params = perturb(jax.jit(lambda k: jae.init(k, jnp.asarray(x)))(jax.random.PRNGKey(3))
                     ["params"], 3, 0.02)
    ae = SimpleAutoencoder(Config(d), dtype=torch.bfloat16)
    state = {**sequential_state_dict(ae.encoder.specs, params["encoder"], "encoder.model"),
             **sequential_state_dict(ae.decoder.specs, params["decoder"], "decoder.model")}
    for name in ("quant_conv", "post_quant_conv"):
        state[f"{name}.weight"] = torch.tensor(params[name]["kernel"].T[:, :, None, None])
        state[f"{name}.bias"] = torch.tensor(params[name]["bias"])
    load(ae, state)

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
    run("decoder", np.random.default_rng(5).standard_normal((2, 4, 4, 16)).astype(np.float32))
    assert set(found) == set(bounds)
    report = ", ".join(f"{k} {e:.2e} x max|ref| {n / t:.4%}" for k, (e, n, t) in sorted(found.items()))
    for kind, (err, n, total) in found.items():
        assert err <= 1e-2 and n / total <= bounds[kind], \
            f"{kind}: {n / total:.4%} differ (<= {bounds[kind]:.4%}); all: {report}"


def test_autoencoder_bf16_per_layer_kind():
    """The bf16 autoencoder (the test model with encoder attention, so both
    stacks hold d-space FABs) layer by layer against the jitted JAX AE
    (``_per_layer_kind``), each kind within ``_AE_BOUNDS``."""
    _per_layer_kind({**small_ns2d_dict(), "use_attn_enc": True}, _AE_BOUNDS)


# Path 6's model at test size, measured (FourierBasicBlocks at the encoder's
# 32x32 and 16x16, modes 6, and the decoder's 32x32 head, modes 16; each
# layer fed the JAX layer's bf16 input): the Fourier layers 0 % differ; the
# other kinds their sum-order residues at these weights, conv 3 of 160,256
# elements and upsample+conv 2 of 90,112 (each within 1.3e-3 x max|ref|),
# resblock 0.031 %, FAB 0 %. Bounds: those shares; the others _AE_BOUNDS'.
_FOURIER_AE_BOUNDS = {**_AE_BOUNDS, "fourier": 0.0, "conv": 1.9e-5, "upsample+conv": 2.3e-5}


def test_fourier_autoencoder_bf16_per_layer_kind():
    """Path 6's model at test size (``final_smoothing``, ``fourier_resolutions``
    [32, 16], encoder attention on) layer by layer against the jitted JAX AE
    in bf16, each kind within ``_FOURIER_AE_BOUNDS``."""
    _per_layer_kind({**small_ns2d_dict(), "use_attn_enc": True, "final_smoothing": True,
                     "fourier_resolutions": [32, 16]}, _FOURIER_AE_BOUNDS)
