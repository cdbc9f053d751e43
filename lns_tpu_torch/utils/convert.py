"""JAX parameter trees -> the port's state dicts.

``state_dict_from_jax`` turns the JAX package's ``{'vq_ae', 'propagator'}``
parameter tree (nested dicts of numpy arrays; ``np.asarray`` of the JAX
arrays) into the state dict of ``lns_tpu_torch.models.LatentDynamics``,
which carries the reference's key names and OIHW / [out, in] layouts. It
follows ``lns_tpu.utils.torch_export.export_latent_dynamics`` for the
families this package runs (the periodic square NS2d autoencoder, the
half-periodic SW autoencoder, the non-squared two-phase autoencoder, the
plain SimpleCNN propagator and the conditional two-phase family's
CondSimpleCNN, whose autoencoder lives under ``ae.``), driven by the port's
own layer specs, and imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from lns_tpu_torch.models.specs import decoder_spec, encoder_spec


def _conv(out, key, p, bias=True):
    k = np.asarray(p["kernel"])
    # [I, O] pointwise -> [O, I, 1, 1]; HWIO -> OIHW
    out[key + ".weight"] = k.T[:, :, None, None] if k.ndim == 2 else k.transpose(3, 2, 0, 1)
    if bias:
        out[key + ".bias"] = np.asarray(p["bias"])


def _linear(out, key, p, bias=True):
    out[key + ".weight"] = np.asarray(p["kernel"]).T
    if bias:
        out[key + ".bias"] = np.asarray(p["bias"])


def _norm(out, key, p):
    out[key + ".weight"] = np.asarray(p["scale"])
    out[key + ".bias"] = np.asarray(p["bias"])


def _rotary_inv_freq(dim: int) -> np.ndarray:
    return 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def _pooling(out, key, p):
    _linear(out, f"{key}.to_in", p["to_in"], bias=False)
    _norm(out, f"{key}.out_ffn.0", p["ffn_ln"])
    _linear(out, f"{key}.out_ffn.1", p["ffn_fc1"], bias=False)
    _linear(out, f"{key}.out_ffn.3", p["ffn_fc2"])


def _sequential(out, specs, params, prefix):
    pre = prefix + "." if prefix else ""
    for spec in specs:
        if spec.kind in ("swish", "resize"):
            continue
        p, kw, pf = params[spec.name], spec.kw, f"{pre}{spec.idx}"
        if spec.kind == "conv":
            _conv(out, pf, p)
        elif spec.kind == "gn":
            _norm(out, pf + (".gn" if kw.get("wrapper") else ""), p)
        elif spec.kind == "resblock":
            _norm(out, f"{pf}.block.0.gn", p["gn1"])
            _conv(out, f"{pf}.block.2", p["conv1"])
            _norm(out, f"{pf}.block.3.gn", p["gn2"])
            _conv(out, f"{pf}.block.5", p["conv2"])
            if kw["in_channels"] != kw["out_channels"]:
                _conv(out, f"{pf}.channel_up", p["channel_up"])
        elif spec.kind == "hp_conv":
            _conv(out, pf, p["conv"])
        elif spec.kind == "hp_resblock":
            _norm(out, f"{pf}.norm_act1.norm_act.0.gn", p["gn1"])
            _conv(out, f"{pf}.conv1", p["conv1"]["conv"])
            _norm(out, f"{pf}.norm_act2.norm_act.0.gn", p["gn2"])
            _conv(out, f"{pf}.conv2", p["conv2"]["conv"])
            if kw["in_channels"] != kw["out_channels"]:
                _conv(out, f"{pf}.channel_up", p["channel_up"])
        elif spec.kind in ("down", "up"):
            _conv(out, f"{pf}.conv_layer", p["conv"])
        elif spec.kind in ("hp_down", "hp_up"):
            _conv(out, f"{pf}.conv_layer", p["conv"]["conv"])
        elif spec.kind == "sablock":
            _norm(out, f"{pf}.ln", p["ln"])
            _linear(out, f"{pf}.to_q", p["to_q"], bias=False)
            _linear(out, f"{pf}.to_k", p["to_k"], bias=False)
            _linear(out, f"{pf}.to_v", p["to_v"])
            _linear(out, f"{pf}.proj_out", p["proj_out"])
            if kw["use_pe"]:
                out[f"{pf}.pe"] = np.asarray(p["pe"])
        elif spec.kind == "fablock":
            _norm(out, f"{pf}.in_norm", p["in_norm"])
            _conv(out, f"{pf}.in_proj", p["in_proj"], bias=False)
            _conv(out, f"{pf}.to_in.0", p["to_in"], bias=False)
            _pooling(out, f"{pf}.to_x.0", p["to_x"])
            _pooling(out, f"{pf}.to_y.1", p["to_y"])
            inv = _rotary_inv_freq(kw["dim_head"] * 2)  # kernel_multiplier 2
            for axis in ("x", "y"):
                lrk = f"{pf}.low_rank_kernel_{axis}"
                _linear(out, f"{lrk}.to_qk", p[f"low_rank_kernel_{axis}"]["to_qk"], bias=False)
                out[f"{lrk}.pos_emb.inv_freq"] = inv
            _conv(out, f"{pf}.to_out.1", p["out_fc1"], bias=False)
            _conv(out, f"{pf}.to_out.3", p["out_fc2"], bias=False)
        else:
            raise NotImplementedError(f"layer kind {spec.kind!r} is not ported yet")


def _cond_blocks(out, cfg, params, prefix):
    """The CondSimpleCNN's embedding MLP and blocks
    (``torch_export.export_propagator``'s conditional keys)."""
    _linear(out, f"{prefix}cond_emb_proj.0", params["cond_proj_fc1"])
    _linear(out, f"{prefix}cond_emb_proj.2", params["cond_proj_fc2"])
    for i in range(cfg.prop_n_block):
        b, pf = params[f"net{i}"], f"{prefix}net.{i}"
        _linear(out, f"{pf}.cond_emb", b["cond_emb"])
        _norm(out, f"{pf}.conv1.0", b["conv1_gn"])
        _conv(out, f"{pf}.conv1.1", b["conv1_a"])
        _conv(out, f"{pf}.conv1.3", b["conv1_b"])
        _norm(out, f"{pf}.cond_conv1.0", b["cond_conv1_gn"])
        _conv(out, f"{pf}.cond_conv1.2", b["cond_conv1"])
        _norm(out, f"{pf}.cond_conv2.0", b["cond_conv2_gn"])
        _conv(out, f"{pf}.cond_conv2.1", b["cond_conv2_fc1"])
        _conv(out, f"{pf}.cond_conv2.3", b["cond_conv2_fc2"])
        _norm(out, f"{pf}.ffn.0", b["ffn_gn"])
        _conv(out, f"{pf}.ffn.1", b["ffn_fc1"], bias=False)
        _conv(out, f"{pf}.ffn.3", b["ffn_fc2"], bias=False)


def _blocks(out, cfg, params, prefix):
    """The SimpleCNN's blocks."""
    for i in range(cfg.prop_n_block):
        b, pf = params[f"net{i}"], f"{prefix}net.{i}"
        _norm(out, f"{pf}.conv.0", b["conv_gn"])
        for j, name in ((1, "conv1"), (3, "conv2"), (5, "conv3")):
            p = b[name]
            _conv(out, f"{pf}.conv.{j}", p if "kernel" in p else p["conv"])  # half-periodic
        _norm(out, f"{pf}.ffn.0", b["ffn_gn"])
        _conv(out, f"{pf}.ffn.1", b["ffn_fc1"], bias=False)
        _conv(out, f"{pf}.ffn.3", b["ffn_fc2"], bias=False)


def _propagator(out, cfg, params, prefix):
    prefix = prefix + "." if prefix else ""
    _conv(out, f"{prefix}in_proj", params["in_proj"])
    (_cond_blocks if cfg.is_conditional else _blocks)(out, cfg, params, prefix)
    _norm(out, f"{prefix}out_proj.0.gn", params["out_gn"])
    _conv(out, f"{prefix}out_proj.1", params["out_proj"])


def state_dict_from_jax(cfg, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'vq_ae', 'propagator'}`` (optionally under ``'params'``) -> the
    state dict of ``LatentDynamics(cfg)``, f32 tensors on the CPU; the
    autoencoder's keys under ``ae.`` for a conditional config, as
    ``export_latent_dynamics`` writes them, else ``vq_ae.``."""
    params = params.get("params", params)
    ae = params["vq_ae"]
    pre = "ae" if cfg.is_conditional else "vq_ae"
    out: Dict[str, np.ndarray] = {}
    _sequential(out, encoder_spec(cfg), ae["encoder"], f"{pre}.encoder.model")
    _sequential(out, decoder_spec(cfg), ae["decoder"], f"{pre}.decoder.model")
    _conv(out, f"{pre}.quant_conv", ae["quant_conv"])
    _conv(out, f"{pre}.post_quant_conv", ae["post_quant_conv"])
    _propagator(out, cfg, params["propagator"], "propagator")
    return _tensors(out)


def sequential_state_dict(specs, params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX params of a spec-built stack (``{spec.name: ...}``) -> the
    state dict of the port's layers under ``{prefix}.{idx}``."""
    out: Dict[str, np.ndarray] = {}
    _sequential(out, specs, params, prefix)
    return _tensors(out)


def propagator_state_dict(cfg, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SimpleCNN`` (``CondSimpleCNN`` for a conditional config) params
    -> the port's propagator state dict."""
    out: Dict[str, np.ndarray] = {}
    _propagator(out, cfg, params, "")
    return _tensors(out)


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.array(v, dtype=np.float32)) for k, v in out.items()}
