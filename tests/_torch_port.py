"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Each test runs the same numpy inputs, made from a seed, through a JAX
function of ``lns_tpu`` and its counterpart in ``lns_tpu_torch``, with the
JAX parameters converted by ``lns_tpu_torch.utils.convert``. Layouts: JAX is
NHWC; the port's modules take NCHW tensors in channels-last memory, which is
the same memory as NHWC (``permute(0, 3, 1, 2)``).
"""

import jax
import numpy as np
import torch

torch.set_num_threads(2)


def small_ns2d_dict():
    """The NS2d model family at test size: 32x32 field, 4x4 latent, two
    FAB blocks (8x8 and 16x16) and the fused 2x upsample before the
    decoder's last conv, as at full size (64x64, 8x8, FABs at 16 and 32)."""
    import __graft_entry__ as g

    cfg = g._ns2d_cfg(res=32, latent_res=4).replace(
        encoder_channels=[32, 32, 32, 64, 64], decoder_channels=[64, 64, 32, 32],
        attn_resolutions=[8, 16], attn_heads=4, attn_dim=16,
        prop_n_block=2, prop_n_embd=32,
    )
    return cfg.to_dict()


def perturb(params, seed: int, scale: float = 0.1):
    """Add seeded numpy noise to every leaf, so that norm scales and shifts
    and zero-initialised biases are not trivial; returns numpy leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch tensor in channels-last memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def load(module: torch.nn.Module, state) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    return module.eval()
