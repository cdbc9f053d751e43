"""A synthetic NS2d corpus in the on-disk format the loader reads (copy of
``_smooth_field`` and ``make_ns2d_npz`` from ``lns_tpu.data.synthetic``):
smooth random Fourier mixtures, so training can reduce the loss. The same
seed gives the same bytes as the JAX package's copy."""

from __future__ import annotations

import numpy as np


def _smooth_field(rng, t, h, w, k=4):
    """Smooth space-time field [t, h, w] from a few random Fourier modes."""
    ty, tx = np.meshgrid(np.linspace(0, 2 * np.pi, h, endpoint=False),
                         np.linspace(0, 2 * np.pi, w, endpoint=False), indexing="ij")
    out = np.zeros((t, h, w), np.float32)
    for _ in range(k):
        ky, kx = rng.integers(1, 4, 2)
        amp = rng.normal(0, 1)
        ph = rng.uniform(0, 2 * np.pi)
        om = rng.uniform(0.1, 0.5)
        for ti in range(t):
            out[ti] += amp * np.sin(ky * ty + kx * tx + ph + om * ti)
    return out


def make_ns2d_npz(path: str, ncase: int = 8, case_len: int = 6, h: int = 32, w: int = 32,
                  seed: int = 0) -> str:
    """Write an NS2d-format .npz (``all_sol_center/forward/backward``, each
    [T, H, W, Ncase], as dataset/ns2d_fno_stage1.py reads) to `path`."""
    rng = np.random.default_rng(seed)
    sol = np.stack([_smooth_field(rng, case_len, h, w) for _ in range(ncase)], axis=-1)
    np.savez(path, all_sol_center=sol, all_sol_forward=sol, all_sol_backward=sol)
    return path
