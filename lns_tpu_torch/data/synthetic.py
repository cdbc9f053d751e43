"""Synthetic NS2d, two-phase and SW corpora in the on-disk formats the
loaders read (copies of ``_smooth_field``, ``make_ns2d_npz``,
``make_twophase_dir`` and ``make_sw_store`` from
``lns_tpu.data.synthetic``): smooth random Fourier mixtures, so training
can reduce the loss. The same seed gives the same bytes as the JAX
package's copy."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from lns_tpu_torch.data.zarr_reader import write_zarr_array


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


def make_twophase_dir(path: str, ncase: int = 8, case_len: int = 6, h: int = 61, w: int = 121,
                      seed: int = 0, with_freq: bool = True) -> str:
    """Write a two-phase directory of per-case .npz (vel [T, H, W, 2], prs
    and vof [T, H, W], a scalar ``freq`` when `with_freq`), as
    dataset/twophase_flow_stage1.py reads it; returns `path`."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(ncase):
        vel = np.stack([_smooth_field(rng, case_len, h, w), _smooth_field(rng, case_len, h, w)],
                       axis=-1)
        prs = _smooth_field(rng, case_len, h, w)
        vof = np.clip(0.5 + 0.5 * _smooth_field(rng, case_len, h, w), 0, 1)
        kw = dict(vel=vel, prs=prs, vof=vof)
        if with_freq:
            kw["freq"] = np.float32(rng.uniform(0.5, 2.0))
        np.savez(os.path.join(path, f"case_{i:04d}.npz"), **kw)
    return path


def make_sw_store(dirpath: str, ncase: int = 6, case_len: int = 8, h: int = 32, w: int = 64,
                  seed: int = 0, fmt: str = "zarr") -> Tuple[str, str, str]:
    """Write an SW corpus: train and test stores (zarr directories or .npz,
    u / v / pres each [N, T, H, W]; the test split max(2, ncase // 3)
    cases) and ``normstats.npz``; returns the three paths."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)

    def corpus(n):
        return tuple(np.stack([_smooth_field(rng, case_len, h, w) for _ in range(n)])
                     for _ in range(3))

    paths = []
    for split, n in (("train", ncase), ("test", max(2, ncase // 3))):
        u, v, p = corpus(n)
        if fmt == "zarr":
            store = os.path.join(dirpath, f"{split}.zarr")
            os.makedirs(store, exist_ok=True)
            for name, arr in (("u", u), ("v", v), ("pres", p)):
                write_zarr_array(os.path.join(store, name), arr, chunks=(1, case_len, h, w))
        else:
            store = os.path.join(dirpath, f"{split}.npz")
            np.savez(store, u=u, v=v, pres=p)
        paths.append(store)
        if split == "train":
            stats = {}
            for name, arr in (("u", u), ("v", v), ("pres", p)):
                stats[f"{name}_mean"] = np.float32(arr.mean())
                stats[f"{name}_std"] = np.float32(arr.std())
            stat_path = os.path.join(dirpath, "normstats.npz")
            np.savez(stat_path, **stats)
    return paths[0], paths[1], stat_path
