"""Neural building blocks on NCHW tensors in channels-last memory: norms,
activations, padded convs, residual / resampling blocks, self / linear /
cross attention, factorized axial attention, spectral (FNO) convolutions
and blocks, rotary, sinusoidal and SIREN embeddings, and FiLM / AdaGN /
Fourier conditioning.

The names below are exported lazily (on first access), since the kernels'
wrappers import ``ops.activations`` and ``ops.norms`` imports the kernels.
"""

import importlib

_EXPORTS = {
    "activations": ("ACTIVATION_REGISTRY", "get_activation", "gelu", "swish"),
    "attention": ("CABlock", "LABlock", "SABlock"),
    "conditioning": ("CondResidualBlock", "embed_sequential"),
    "conv": ("Conv1x1", "ConvND", "Dense"),
    "embedding": ("EmbeddingWrapper", "RotaryEmbedding", "Sine", "Siren", "SirenNet",
                  "apply_rotary_pos_emb", "fourier_embedding", "rotate_half"),
    "factorized_attention": ("FABlock2D",),
    "fno": ("CondResFNOMixerBlock", "FourierBasicBlock", "ResFNOMixerBlock"),
    "fourier_cond": ("CondFourierBasicBlock", "CondSpectralConv2d", "FreqLinear"),
    "initializers": ("init_weights_", "zero_init"),
    "norms": ("GroupNorm", "LayerNorm", "instance_norm_2d"),
    "resblocks": ("DownSampleBlock", "DownSampleBlock2dHalfPeriodic", "HalfPeriodicResBlock2d",
                  "ResidualBlock", "UpSampleBlock", "UpSampleBlock2dHalfPeriodic"),
    "spectral": ("SpectralConv1d", "SpectralConv2d", "SpectralConv3d", "batchmul1d",
                 "batchmul2d", "batchmul3d"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
