"""JAX parameter trees <-> the port's state dicts.

``state_dict_from_jax`` turns the JAX package's ``{'vq_ae', 'propagator'}``
parameter tree (nested dicts of numpy arrays; ``np.asarray`` of the JAX
arrays) into the state dict of ``lns_tpu_torch.models.LatentDynamics``,
which carries the reference's key names and OIHW / [out, in] layouts. It
follows ``lns_tpu.utils.torch_export.export_latent_dynamics`` for the
families this package runs (the periodic square NS2d autoencoder, the
half-periodic SW autoencoder, the non-squared two-phase autoencoder, each
with its optional Fourier layers, the plain SimpleCNN propagator and the
conditional two-phase family's CondSimpleCNN, whose autoencoder lives under
``ae.``), driven by the port's own layer specs, and imports no JAX. The
``ConditionalSimpleAutoencoder``'s encoder takes the reference's names
(``lns_tpu.utils.torch_compat.convert_cond_encoder``); a library block
(spectral and FNO blocks, attention, SIREN, the library propagators) its
JAX module names, one to one.

Both directions read one table (``key_table``): each entry names a state
dict key, the path of its leaf in the JAX tree and the layout between the
two (``conv``: a pointwise JAX kernel is [in, out] and a spatial one HWIO,
the port's OIHW either way; ``linear``: [in, out] against [out, in];
``copy``; ``rotary``: a rotary embedding's frequencies, which the port
keeps as a buffer and the JAX tree does not hold). ``state_dict_to_jax``
is the inverse: a state dict back to the JAX tree (``lns_tpu_torch.cli.
convert`` writes it as flax msgpack).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lns_tpu_torch.models.specs import decoder_spec, encoder_spec


class Entry(NamedTuple):
    """One state dict key: its JAX leaf's path (None for a leaf the JAX
    tree does not hold), the layout between the two and, for ``rotary``,
    the embedding's width."""
    key: str
    path: Optional[Tuple[str, ...]]
    layout: str
    dim: int = 0


def _conv(t, key, path, bias=True):
    t.append(Entry(key + ".weight", path + ("kernel",), "conv"))
    if bias:
        t.append(Entry(key + ".bias", path + ("bias",), "copy"))


def _linear(t, key, path, bias=True):
    t.append(Entry(key + ".weight", path + ("kernel",), "linear"))
    if bias:
        t.append(Entry(key + ".bias", path + ("bias",), "copy"))


def _norm(t, key, path):
    t.append(Entry(key + ".weight", path + ("scale",), "copy"))
    t.append(Entry(key + ".bias", path + ("bias",), "copy"))


def _pooling(t, key, path):
    _linear(t, f"{key}.to_in", path + ("to_in",), bias=False)
    _norm(t, f"{key}.out_ffn.0", path + ("ffn_ln",))
    _linear(t, f"{key}.out_ffn.1", path + ("ffn_fc1",), bias=False)
    _linear(t, f"{key}.out_ffn.3", path + ("ffn_fc2",))


def _sequential(t, specs, path, prefix):
    pre = prefix + "." if prefix else ""
    for spec in specs:
        if spec.kind in ("swish", "resize"):
            continue
        p, kw, pf = path + (spec.name,), spec.kw, f"{pre}{spec.idx}"
        if spec.kind == "conv":
            _conv(t, pf, p)
        elif spec.kind == "gn":
            _norm(t, pf + (".gn" if kw.get("wrapper") else ""), p)
        elif spec.kind == "resblock":
            _resblock(t, pf, p, kw["in_channels"] != kw["out_channels"])
        elif spec.kind == "hp_conv":
            _conv(t, pf, p + ("conv",))
        elif spec.kind == "hp_resblock":
            _norm(t, f"{pf}.norm_act1.norm_act.0.gn", p + ("gn1",))
            _conv(t, f"{pf}.conv1", p + ("conv1", "conv"))
            _norm(t, f"{pf}.norm_act2.norm_act.0.gn", p + ("gn2",))
            _conv(t, f"{pf}.conv2", p + ("conv2", "conv"))
            if kw["in_channels"] != kw["out_channels"]:
                _conv(t, f"{pf}.channel_up", p + ("channel_up",))
        elif spec.kind in ("down", "up"):
            _conv(t, f"{pf}.conv_layer", p + ("conv",))
        elif spec.kind in ("hp_down", "hp_up"):
            _conv(t, f"{pf}.conv_layer", p + ("conv", "conv"))
        elif spec.kind == "sablock":
            _norm(t, f"{pf}.ln", p + ("ln",))
            _linear(t, f"{pf}.to_q", p + ("to_q",), bias=False)
            _linear(t, f"{pf}.to_k", p + ("to_k",), bias=False)
            _linear(t, f"{pf}.to_v", p + ("to_v",))
            _linear(t, f"{pf}.proj_out", p + ("proj_out",))
            if kw["use_pe"]:
                t.append(Entry(f"{pf}.pe", p + ("pe",), "copy"))
        elif spec.kind == "fourier":
            _fourier(t, pf, p, len(kw["modes"]))
        elif spec.kind == "fablock":
            _norm(t, f"{pf}.in_norm", p + ("in_norm",))
            _conv(t, f"{pf}.in_proj", p + ("in_proj",), bias=False)
            _conv(t, f"{pf}.to_in.0", p + ("to_in",), bias=False)
            _pooling(t, f"{pf}.to_x.0", p + ("to_x",))
            _pooling(t, f"{pf}.to_y.1", p + ("to_y",))
            for axis in ("x", "y"):
                lrk = f"{pf}.low_rank_kernel_{axis}"
                _linear(t, f"{lrk}.to_qk", p + (f"low_rank_kernel_{axis}", "to_qk"), bias=False)
                # kernel_multiplier 2
                t.append(Entry(f"{lrk}.pos_emb.inv_freq", None, "rotary", kw["dim_head"] * 2))
            _conv(t, f"{pf}.to_out.1", p + ("out_fc1",), bias=False)
            _conv(t, f"{pf}.to_out.3", p + ("out_fc2",), bias=False)
        else:
            raise ValueError(f"unknown layer kind {spec.kind}")


def _resblock(t, key, path, channel_up):
    """A ``ResidualBlock`` (the reference's ``block.{0,2,3,5}``) against the
    JAX block's ``gn1``, ``conv1``, ``gn2``, ``conv2`` (and ``channel_up``)."""
    _norm(t, f"{key}.block.0.gn", path + ("gn1",))
    _conv(t, f"{key}.block.2", path + ("conv1",))
    _norm(t, f"{key}.block.3.gn", path + ("gn2",))
    _conv(t, f"{key}.block.5", path + ("conv2",))
    if channel_up:
        _conv(t, f"{key}.channel_up", path + ("channel_up",))


def _fourier(t, key, path, ndim):
    """A ``FourierBasicBlock``: its spectral banks (``weights`` in 1D,
    ``weights1``-``2`` in 2D, ``weights1``-``4`` in 3D) and the 1x1 bypass
    (``torch_export._put_fourier``)."""
    names = ["weights"] if ndim == 1 else [f"weights{i + 1}" for i in range(2 if ndim == 2 else 4)]
    for name in names:
        t.append(Entry(f"{key}.fourier.{name}", path + ("fourier", name), "copy"))
    _conv(t, f"{key}.conv", path + ("conv",))


def _module(t, m, key, path):
    """A library block, one to one: each submodule under its JAX module
    name, convs, linears and norms in their layouts, every other parameter
    (spectral banks, ``FreqLinear``, embedding tables, positional
    embeddings) copied under its own name; a ``ResidualBlock`` under the
    JAX block's names (``gn1``, ``conv1``, ``gn2``, ``conv2``,
    ``channel_up``)."""
    from lns_tpu_torch.ops.conv import Conv1x1, ConvND, Dense
    from lns_tpu_torch.ops.embedding import Siren
    from lns_tpu_torch.ops.norms import GroupNorm, LayerNorm
    from lns_tpu_torch.ops.resblocks import ResidualBlock

    pre = key + "." if key else ""
    if isinstance(m, ResidualBlock):
        _resblock(t, key, path, m.channel_up is not None)
    elif isinstance(m, (ConvND, Conv1x1)):
        _conv(t, key, path, bias=m.bias is not None)
    elif isinstance(m, (Dense, Siren)):
        _linear(t, key, path, bias=m.bias is not None)
    elif isinstance(m, (GroupNorm, LayerNorm)):
        _norm(t, key, path)
    else:
        for name, _ in m.named_parameters(recurse=False):
            t.append(Entry(pre + name, path + (name,), "copy"))
        for name, child in m.named_children():
            _module(t, child, pre + name, path + (name,))


def _cond_resblock(t, key, path, shortcut):
    """A ``CondResidualBlock`` with its norms, under the JAX block's names
    (the reference's too)."""
    _norm(t, f"{key}.norm1", path + ("norm1",))
    _conv(t, f"{key}.conv1", path + ("conv1",))
    _linear(t, f"{key}.cond_emb", path + ("cond_emb",))
    _norm(t, f"{key}.norm2", path + ("norm2",))
    _conv(t, f"{key}.conv2", path + ("conv2",))
    if shortcut:
        _conv(t, f"{key}.shortcut", path + ("shortcut",))


def _cond_encoder(t, cfg, path, prefix):
    """``CondEncoder`` under the reference's names (``torch_compat.
    convert_cond_encoder``): ``to_in.{0,2}``, ``embed.{0,2}``,
    ``layers.{i}.0.{j}`` (its ``CondResidualBlock``s), ``layers.{i}.1.conv_layer``, ``to_out_conv``,
    ``to_out.0.gn``, ``to_out.2``."""
    channels = list(cfg.encoder_channels)
    _conv(t, f"{prefix}.to_in.0", path + ("to_in_conv1",))
    _conv(t, f"{prefix}.to_in.2", path + ("to_in_conv2",))
    _linear(t, f"{prefix}.embed.0", path + ("embed_fc1",))
    _linear(t, f"{prefix}.embed.2", path + ("embed_fc2",))
    for i in range(len(channels) - 1):
        in_ch = channels[i]
        for j in range(cfg.encoder_res_blocks):
            _cond_resblock(t, f"{prefix}.layers.{i}.0.{j}", path + (f"level{i}_res{j}",),
                           in_ch != channels[i + 1])
            in_ch = channels[i + 1]
        if i != len(channels) - 2:
            _conv(t, f"{prefix}.layers.{i}.1.conv_layer", path + (f"level{i}_down", "conv"))
    _cond_resblock(t, f"{prefix}.to_out_conv", path + ("to_out_conv",), False)
    _norm(t, f"{prefix}.to_out.0.gn", path + ("to_out_gn",))
    _conv(t, f"{prefix}.to_out.2", path + ("to_out_proj",))


def _cond_blocks(t, cfg, path, prefix):
    """The CondSimpleCNN's embedding MLP and blocks
    (``torch_export.export_propagator``'s conditional keys)."""
    _linear(t, f"{prefix}cond_emb_proj.0", path + ("cond_proj_fc1",))
    _linear(t, f"{prefix}cond_emb_proj.2", path + ("cond_proj_fc2",))
    for i in range(cfg.prop_n_block):
        b, pf = path + (f"net{i}",), f"{prefix}net.{i}"
        _linear(t, f"{pf}.cond_emb", b + ("cond_emb",))
        _norm(t, f"{pf}.conv1.0", b + ("conv1_gn",))
        _conv(t, f"{pf}.conv1.1", b + ("conv1_a",))
        _conv(t, f"{pf}.conv1.3", b + ("conv1_b",))
        _norm(t, f"{pf}.cond_conv1.0", b + ("cond_conv1_gn",))
        _conv(t, f"{pf}.cond_conv1.2", b + ("cond_conv1",))
        _norm(t, f"{pf}.cond_conv2.0", b + ("cond_conv2_gn",))
        _conv(t, f"{pf}.cond_conv2.1", b + ("cond_conv2_fc1",))
        _conv(t, f"{pf}.cond_conv2.3", b + ("cond_conv2_fc2",))
        _norm(t, f"{pf}.ffn.0", b + ("ffn_gn",))
        _conv(t, f"{pf}.ffn.1", b + ("ffn_fc1",), bias=False)
        _conv(t, f"{pf}.ffn.3", b + ("ffn_fc2",), bias=False)


def _blocks(t, cfg, path, prefix, half_periodic):
    """The SimpleCNN's blocks; half-periodic convs (SW's) nest their kernel
    one level down (``{'conv': {'kernel', 'bias'}}``)."""
    nest = ("conv",) if half_periodic else ()
    for i in range(cfg.prop_n_block):
        b, pf = path + (f"net{i}",), f"{prefix}net.{i}"
        _norm(t, f"{pf}.conv.0", b + ("conv_gn",))
        for j, name in ((1, "conv1"), (3, "conv2"), (5, "conv3")):
            _conv(t, f"{pf}.conv.{j}", b + (name,) + nest)
        _norm(t, f"{pf}.ffn.0", b + ("ffn_gn",))
        _conv(t, f"{pf}.ffn.1", b + ("ffn_fc1",), bias=False)
        _conv(t, f"{pf}.ffn.3", b + ("ffn_fc2",), bias=False)


def _propagator(t, cfg, path, prefix, half_periodic):
    prefix = prefix + "." if prefix else ""
    _conv(t, f"{prefix}in_proj", path + ("in_proj",))
    if cfg.is_conditional:
        _cond_blocks(t, cfg, path, prefix)
    else:
        _blocks(t, cfg, path, prefix, half_periodic)
    _norm(t, f"{prefix}out_proj.0.gn", path + ("out_gn",))
    _conv(t, f"{prefix}out_proj.1", path + ("out_proj",))


def _autoencoder(t, cfg, path, prefix, conditional=False):
    pre = prefix + "." if prefix else ""
    if conditional:
        _cond_encoder(t, cfg, path + ("encoder",), f"{pre}encoder")
    else:
        _sequential(t, encoder_spec(cfg), path + ("encoder",), f"{pre}encoder.model")
    _sequential(t, decoder_spec(cfg), path + ("decoder",), f"{pre}decoder.model")
    _conv(t, f"{pre}quant_conv", path + ("quant_conv",))
    _conv(t, f"{pre}post_quant_conv", path + ("post_quant_conv",))


def key_table(cfg, kind="dynamics") -> List[Entry]:
    """The state dict keys of `kind` (``dynamics``: ``LatentDynamics(cfg)``,
    its autoencoder under ``ae.`` for a conditional config as
    ``export_latent_dynamics`` writes it, else ``vq_ae.``, and the
    propagator under ``propagator.``; ``ae``: a stage-1 autoencoder's bare
    keys, as ``export_autoencoder`` writes them; ``cond_ae``: a
    ``ConditionalSimpleAutoencoder``'s, its encoder under the reference's
    names; or a library block, an ``nn.Module``, whose keys follow its JAX
    module names one to one, `cfg` unused), each with its JAX leaf."""
    t: List[Entry] = []
    if isinstance(kind, torch.nn.Module):
        _module(t, kind, "", ())
        t = [e._replace(key=e.key.lstrip(".")) for e in t]  # a bare conv, linear or norm
    elif kind in ("ae", "cond_ae"):
        _autoencoder(t, cfg, (), "", conditional=kind == "cond_ae")
    elif kind == "dynamics":
        _autoencoder(t, cfg, ("vq_ae",), "ae" if cfg.is_conditional else "vq_ae")
        _propagator(t, cfg, ("propagator",), "propagator", cfg.workload == "sw")
    else:
        raise ValueError(f"kind {kind!r}: 'ae', 'cond_ae', 'dynamics' or a library block")
    return t


# -- the layouts ------------------------------------------------------------------

def _array(a) -> np.ndarray:
    """A JAX leaf as numpy (a bf16 tensor from the msgpack reader widened
    to f32, exactly)."""
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_port(e: Entry, params) -> np.ndarray:
    if e.layout == "rotary":
        return 1.0 / (10000 ** (np.arange(0, e.dim, 2, dtype=np.float32) / e.dim))
    a = params
    for name in e.path:
        a = a[name]
    a = _array(a)
    if e.layout == "conv":  # [I, O] pointwise -> [O, I, 1, 1]; HWIO -> OIHW
        return a.T[:, :, None, None] if a.ndim == 2 else a.transpose(3, 2, 0, 1)
    return a.T if e.layout == "linear" else a


def _to_jax(e: Entry, w: np.ndarray) -> np.ndarray:
    if e.layout == "conv":  # a 1x1 kernel is a JAX Dense's [I, O]
        return w[:, :, 0, 0].T if w.shape[2:] == (1, 1) else w.transpose(2, 3, 1, 0)
    return w.T if e.layout == "linear" else w


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.array(v, dtype=np.float32)) for k, v in out.items()}


def _from_table(table: List[Entry], params) -> Dict[str, torch.Tensor]:
    return _tensors({e.key: _to_port(e, params) for e in table})


def state_dict_from_jax(cfg, params: Dict[str, Any], kind="dynamics"
                        ) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (optionally under ``'params'``) -> the state
    dict of `kind` (``key_table``): ``{'vq_ae', 'propagator'}`` -> that of
    ``LatentDynamics(cfg)``, an autoencoder's tree -> a stage-1 ``.pt``'s,
    a library block's tree -> that block's (`kind` the block); f32 tensors
    on the CPU."""
    return _from_table(key_table(cfg, kind), params.get("params", params))


def state_dict_to_jax(cfg, state: Dict[str, torch.Tensor], kind="dynamics"
                      ) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_jax``: a state dict of `kind` -> the
    JAX parameter tree (nested dicts of f32 numpy arrays, the JAX layouts),
    from the same ``key_table``. Every key of `state` must be in the table
    and every table key that the JAX tree holds in `state`."""
    table = key_table(cfg, kind)
    known = {e.key for e in table}
    extra = sorted(set(state) - known)
    missing = sorted(e.key for e in table if e.path is not None and e.key not in state)
    if extra or missing:
        raise KeyError(f"state dict against the {kind} key table: unexpected {extra[:5]}, "
                       f"missing {missing[:5]}")
    tree: Dict[str, Any] = {}
    for e in table:
        if e.path is None:
            continue
        node = tree
        for name in e.path[:-1]:
            node = node.setdefault(name, {})
        node[e.path[-1]] = _to_jax(e, state[e.key].detach().cpu().float().numpy())
    return tree


def sequential_state_dict(specs, params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX params of a spec-built stack (``{spec.name: ...}``) -> the
    state dict of the port's layers under ``{prefix}.{idx}``."""
    t: List[Entry] = []
    _sequential(t, specs, (), prefix)
    return _from_table(t, params)


def propagator_state_dict(cfg, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SimpleCNN`` (``CondSimpleCNN`` for a conditional config) params
    -> the port's propagator state dict; its convs are half-periodic where
    the tree nests their kernels."""
    t: List[Entry] = []
    _propagator(t, cfg, (), "", "kernel" not in params.get("net0", {}).get("conv1", {"kernel": 0}))
    return _from_table(t, params)
