"""Parity of the PyTorch port's building blocks (lns_tpu_torch.ops, config,
specs) with their JAX counterparts in lns_tpu, in f32 on the CPU.

Tolerances: GroupNorm 2e-6, as tests/test_pallas_kernels.py holds the GN
kernel. Single convs and blocks 2e-5: the two frameworks' f32 convolutions
sum in different orders (3x3x64 terms of unit scale). Attention blocks 1e-4:
softmax / rotary / two axial contractions and the folded InstanceNorm add a
few more f32 roundings on values of order 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import lns_tpu.ops as jops
from lns_tpu.config import Config as JConfig
from lns_tpu.models import specs as jspecs
from lns_tpu.ops import embedding as jemb
from lns_tpu.ops.factorized_attention import LowRankKernel as JLowRankKernel
from lns_tpu.ops.factorized_attention import PoolingReducer as JPoolingReducer
from lns_tpu_torch import config as tconfig
from lns_tpu_torch.models import specs as tspecs
from lns_tpu_torch.ops import activations, embedding, norms, padding
from lns_tpu_torch.ops.attention import SABlock
from lns_tpu_torch.ops.conv import ConvND
from lns_tpu_torch.ops.factorized_attention import FABlock2D, LowRankKernel, PoolingReducer
from lns_tpu_torch.ops.resblocks import DownSampleBlock, ResidualBlock, UpSampleBlock
from lns_tpu_torch.utils.convert import sequential_state_dict

from _torch_port import load, nchw, nhwc, perturb, small_ns2d_dict


def _port_state(kind, params, **kw):
    """Convert one JAX layer's params through the port's converter."""
    spec = tspecs.LayerSpec(0, kind, tuple(sorted(kw.items())))
    state = sequential_state_dict([spec], {"m0": params})
    return {k[2:]: v for k, v in state.items()}  # drop the "0." prefix


def _init(module, x, seed=1):
    return perturb(module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)


# -- config and specs ---------------------------------------------------------

def test_config_semantics():
    cfg = tconfig.ns2d_config()
    assert cfg.to_dict() == graft._ns2d_cfg().to_dict()
    assert cfg.missing_key is None and "latent_dim" in cfg
    small = tconfig.ns2d_config(res=16, latent_res=4)
    assert small.to_dict() == graft._ns2d_cfg(res=16, latent_res=4).to_dict()
    edited = cfg.replace(prop_n_block=2)
    assert edited.prop_n_block == 2 and cfg.prop_n_block == 3
    assert (cfg.workload, cfg.ae_variant, cfg.is_conditional) == ("ns2d", "periodic", False)
    cond = tconfig.Config(graft._tiny_cond_cfg().to_dict())
    assert (cond.workload, cond.is_conditional) == ("twophase_conditional", True)
    assert tconfig.Config(graft._tiny_hp_cfg().to_dict()).workload == "sw"


def test_load_config_reads_yaml(tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text("latent_dim: 16\nencoder_channels: [64, 128]\nnested:\n  a: 1\n")
    cfg = tconfig.load_config(str(path))
    assert cfg.latent_dim == 16 and cfg.encoder_channels == [64, 128]
    assert cfg.nested.a == 1 and cfg.absent is None


@pytest.mark.parametrize("name", ["_ns2d_cfg", "_tiny_hp_cfg", "_tiny_cond_cfg"])
def test_specs_match_jax(name):
    jcfg = getattr(graft, name)()
    tcfg = tconfig.Config(jcfg.to_dict())
    for spec_fn in ("encoder_spec", "decoder_spec"):
        ours = [(s.idx, s.kind, s.kwargs) for s in getattr(tspecs, spec_fn)(tcfg)]
        ref = [(s.idx, s.kind, s.kwargs) for s in getattr(jspecs, spec_fn)(jcfg)]
        assert ours == ref, spec_fn


# -- activations, padding, norms -----------------------------------------------

def test_activations_match_jax():
    x = np.random.default_rng(0).standard_normal((4, 33)).astype(np.float32) * 3
    t = torch.from_numpy(x)
    np.testing.assert_allclose(activations.swish(t).numpy(),
                               np.asarray(jops.swish(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(activations.gelu(t).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                               atol=1e-6)


@pytest.mark.parametrize("mode,pads", [("circular", [(1, 1), (2, 2)]),
                                       ("zeros", [(0, 1), (0, 1)]),
                                       ("circular", [(1, 1), (1, 1)])])
def test_pad_nd_matches_jax(mode, pads):
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jops.pad_nd(jnp.asarray(x), pads, mode=mode))
    np.testing.assert_array_equal(nhwc(padding.pad_nd(nchw(x), pads, mode=mode)), ref)


@pytest.mark.parametrize("groups,eps,swish,shape", [
    (32, 1e-6, True, (3, 16, 16, 64)),     # ResidualBlock prologue
    (32, 1e-6, False, (2, 8, 8, 128)),     # propagator out_proj GN(32)
    (8, 1e-5, True, (2, 16, 16, 64)),      # decoder tail GN(8) + swish
    (1, 1e-5, False, (2, 12, 20, 64)),     # FAB in_norm GN(1)
])
def test_group_norm_matches_jax(groups, eps, swish, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 2 + 0.5
    c = shape[-1]
    jgn = jops.GroupNorm(groups, c, eps=eps)
    p = _init(jgn, x)
    ref = jgn.apply({"params": p}, jnp.asarray(x))
    if swish:
        ref = ref * jax.nn.sigmoid(ref)
    gn = load(norms.GroupNorm(groups, c, eps), _port_state("gn", p, groups=groups,
                                                          channels=c, eps=eps, wrapper=False))
    out = nhwc(gn(nchw(x), apply_swish=swish))
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-6)


def test_layer_norm_and_instance_norm_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 6, 8, 24)).astype(np.float32) + 1
    jln = jops.LayerNorm(24)
    p = _init(jln, x)
    ln = load(norms.LayerNorm(24), {"weight": torch.tensor(p["scale"]),
                                    "bias": torch.tensor(p["bias"])})
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jln.apply({"params": p}, jnp.asarray(x))), atol=2e-6)
    ref = np.asarray(jops.instance_norm_2d(jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(norms.instance_norm_2d(nchw(x))), ref, atol=2e-6)


# -- convolutions and blocks ---------------------------------------------------

@pytest.mark.parametrize("mode,dil,up,stride", [
    ("circular", 1, False, 1), ("circular", 2, False, 1), ("zeros", 1, False, 1),
    ("circular", 1, True, 1), ("zeros", 1, True, 1), ("zeros", 1, False, 2),
])
def test_conv_matches_jax(mode, dil, up, stride):
    x = np.random.default_rng(4).standard_normal((2, 8, 12, 16)).astype(np.float32)
    kw = dict(features=24, kernel_size=3, padding=dil, padding_mode=mode,
              dilation=dil, upsample_2x=up, stride=stride)
    jconv = jops.ConvND(**kw)
    p = _init(jconv, x)
    ref = np.asarray(jconv.apply({"params": p}, jnp.asarray(x)))
    conv = load(ConvND(16, 24, 3, stride=stride, padding=dil, dilation=dil, padding_mode=mode,
                       upsample_2x=up), _port_state("conv", p, **kw))
    np.testing.assert_allclose(nhwc(conv(nchw(x))), ref, atol=2e-5)


@pytest.mark.parametrize("cin,cout,mode", [(32, 64, "circular"), (64, 64, "zeros")])
def test_residual_block_matches_jax(cin, cout, mode):
    x = np.random.default_rng(5).standard_normal((2, 8, 8, cin)).astype(np.float32)
    jblk = jops.ResidualBlock(cin, cout, padding_mode=mode)
    p = _init(jblk, x)
    ref = np.asarray(jblk.apply({"params": p}, jnp.asarray(x)))
    blk = load(ResidualBlock(cin, cout, padding_mode=mode),
               _port_state("resblock", p, in_channels=cin, out_channels=cout))
    np.testing.assert_allclose(nhwc(blk(nchw(x))), ref, atol=2e-5)


@pytest.mark.parametrize("kind,mode,hw", [("down", "circular", (8, 8)), ("down", "zeros", (7, 15)),
                                          ("up", "circular", (4, 4)), ("up", "zeros", (4, 6))])
def test_resample_blocks_match_jax(kind, mode, hw):
    x = np.random.default_rng(6).standard_normal((2,) + hw + (32,)).astype(np.float32)
    jcls, tcls = {"down": (jops.DownSampleBlock, DownSampleBlock),
                  "up": (jops.UpSampleBlock, UpSampleBlock)}[kind]
    jblk = jcls(32, padding_mode=mode)
    p = _init(jblk, x)
    ref = np.asarray(jblk.apply({"params": p}, jnp.asarray(x)))
    blk = load(tcls(32, padding_mode=mode), _port_state(kind, p, channels=32))
    out = nhwc(blk(nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5)


# -- attention -----------------------------------------------------------------

def test_rotary_matches_jax():
    pos = np.linspace(0, 1, 12, dtype=np.float32)[None]
    freqs = embedding.rotary_freqs(torch.from_numpy(pos), 32)
    ref = np.asarray(jemb.rotary_freqs(jnp.asarray(pos), 32))
    np.testing.assert_allclose(freqs.numpy(), ref, rtol=1e-6)
    t = np.random.default_rng(7).standard_normal((2, 3, 12, 32)).astype(np.float32)
    out = embedding.apply_rotary_pos_emb(torch.from_numpy(t), torch.tensor(ref))
    np.testing.assert_allclose(out.numpy(), np.asarray(jemb.apply_rotary_pos_emb(
        jnp.asarray(t), jnp.asarray(ref))), atol=1e-6)
    np.testing.assert_array_equal(embedding.rotate_half(torch.from_numpy(t)).numpy(),
                                  np.asarray(jemb.rotate_half(jnp.asarray(t))))


def test_sablock_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 8, 8, 64)).astype(np.float32)
    jblk = jops.SABlock(64, 4, 16, use_pe=True, block_size=64)
    p = _init(jblk, x)
    ref = np.asarray(jblk.apply({"params": p}, jnp.asarray(x)))
    blk = load(SABlock(64, 4, 16, use_pe=True, block_size=64),
               _port_state("sablock", p, dim=64, heads=4, dim_head=16, use_pe=True,
                           block_size=64))
    np.testing.assert_allclose(nhwc(blk(nchw(x))), ref, atol=1e-4)


def test_low_rank_kernel_and_pooling_reducer_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    jk = JLowRankKernel(16, 32, 4, use_rotary_emb=True)
    p = _init(jk, x)
    k = load(LowRankKernel(16, 32, 4, use_rotary_emb=True), {
        "to_qk.weight": torch.tensor(p["to_qk"]["kernel"].T),
        "pos_emb.inv_freq": embedding.rotary_inv_freq(32)})
    np.testing.assert_allclose(k(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jk.apply({"params": p}, jnp.asarray(x))), atol=1e-4)

    f = rng.standard_normal((2, 6, 10, 24)).astype(np.float32)
    jr = JPoolingReducer(24, 24, 16)
    p = _init(jr, f)
    r = load(PoolingReducer(24, 24, 16), {
        "to_in.weight": torch.tensor(p["to_in"]["kernel"].T),
        "out_ffn.0.weight": torch.tensor(p["ffn_ln"]["scale"]),
        "out_ffn.0.bias": torch.tensor(p["ffn_ln"]["bias"]),
        "out_ffn.1.weight": torch.tensor(p["ffn_fc1"]["kernel"].T),
        "out_ffn.3.weight": torch.tensor(p["ffn_fc2"]["kernel"].T),
        "out_ffn.3.bias": torch.tensor(p["ffn_fc2"]["bias"])})
    np.testing.assert_allclose(r(torch.from_numpy(f)).detach().numpy(),
                               np.asarray(jr.apply({"params": p}, jnp.asarray(f))), atol=2e-5)


@pytest.mark.parametrize("hw", [(8, 8), (8, 12), (12, 8)])
def test_fablock_matches_jax(hw):
    """Square and non-square fields, both orientations of the JAX core's
    ``w > h`` branch. With c = d = 32 the JAX block takes the c-space Gram
    core (``_fab_impl_for``: 5c < 9d), the core the port's kernel carries."""
    c, heads, d = 32, 4, 32
    x = np.random.default_rng(10).standard_normal((2,) + hw + (c,)).astype(np.float32)
    jblk = jops.FABlock2D(c, d, d, heads, c)
    p = _init(jblk, x)
    ref = np.asarray(jblk.apply({"params": p}, jnp.asarray(x)))
    blk = load(FABlock2D(c, d, d, heads, c),
               _port_state("fablock", p, dim=c, dim_head=d, latent_dim=d, heads=heads, dim_out=c))
    np.testing.assert_allclose(nhwc(blk(nchw(x))), ref, atol=1e-4)


def test_config_is_shared_with_jax_dicts():
    """A JAX Config's dict builds the port's Config unchanged."""
    d = small_ns2d_dict()
    assert tconfig.Config(d).to_dict() == JConfig(d).to_dict()
