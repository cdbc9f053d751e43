"""Finite-difference rotating shallow-water solver on a beta-plane channel
(counterpart of ``lns_tpu.data.sw_solver``): the SW corpus generator.

A zonally periodic channel with free-slip walls at the two y boundaries,
the topology of PDEArena's ShallowWater-2D store (u, v, pres on 96x192,
periodic in x) that the half-periodic autoencoder encodes. Collocated
centred differences (a periodic wrap in x; ghost rows in y, even parity
for u and eta, odd for v, v = 0 on the wall rows), classic RK4 in time,
Laplacian viscosity; g = 1, mean depth 1:

    u_t = -(u u_x + v u_y) + f v - g eta_x + nu lap u
    v_t = -(u v_x + v v_y) - f u - g eta_y + nu lap v
    eta_t = -d/dx((H0+eta) u) - d/dy((H0+eta) v) + nu lap eta

with f(y) = f0 + beta (y - 1/2), from smooth random height fields in
geostrophic balance. The state is f32 on the device, stepped in the JAX
function's operator order; each record is copied to the host as it is
made (the JAX package keeps them on the device until the end). It runs on
the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from lns_tpu_torch.data.ns2d_solver import solver_device


def _initial_eta(rng: np.random.Generator, ncase: int, h: int, w: int,
                 amp: float = 0.12, kmax: int = 4) -> np.ndarray:
    """Random smooth height anomaly [ncase, h, w] f64: zonal Fourier modes x
    cos(pi k y) wall modes (zero y-derivative at both walls); the JAX
    package's function bitwise."""
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 2.0, w, endpoint=False)[None, :]
    eta = np.zeros((ncase, h, w), np.float64)
    for c in range(ncase):
        for _ in range(6):
            kx = rng.integers(1, kmax + 1)
            ky = rng.integers(0, kmax + 1)
            ph = rng.uniform(0, 2 * np.pi)
            a = rng.normal(0, 1.0) / (1.0 + kx * kx + ky * ky)
            eta[c] += a * np.cos(np.pi * ky * y) * np.cos(np.pi * kx * x + ph)
    eta *= amp / (np.abs(eta).max(axis=(1, 2), keepdims=True) + 1e-12)
    return eta


def simulate_sw(eta0: np.ndarray, f0: float = 6.0, beta: float = 8.0,
                nu: float = 5e-4, dt: float = 2e-3, t_record: float = 0.05,
                n_records: int = 88, spinup_records: int = 12,
                device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integrate from height anomaly eta0 [ncase, h, w]; returns (u, v,
    pres) as [ncase, n_records, h, w] f32 each. Velocities start in
    geostrophic balance; `spinup_records` earlier records are integrated
    and dropped. Raises ``FloatingPointError`` when a recorded value is not
    finite. On the card unless `device` names another."""
    dev = solver_device(device, "simulate_sw")
    ncase, h, w = eta0.shape
    dy = 1.0 / (h - 1)
    dx = 2.0 / w
    g = 1.0
    h0 = 1.0
    steps_per_rec = int(round(t_record / dt))

    yy = np.linspace(0.0, 1.0, h)[:, None]
    f_cor_np = (f0 + beta * (yy - 0.5)).astype(np.float32)  # [h, 1]
    f_cor = torch.from_numpy(f_cor_np).to(dev)

    # XLA folds a division by a constant into a product with its f32
    # reciprocal, so the JAX function's `/ (2 * dx)` and `/ dx**2` are
    # written as those products
    inv_2dx, inv_2dy = np.float32(1) / np.float32(2 * dx), np.float32(1) / np.float32(2 * dy)
    inv_dx2, inv_dy2 = np.float32(1) / np.float32(dx**2), np.float32(1) / np.float32(dy**2)

    def ddx(a):
        return (torch.roll(a, -1, dims=-1) - torch.roll(a, 1, dims=-1)) * inv_2dx

    def _ghost(a, parity):
        # free-slip wall ghosts: even fields reflect (zero normal gradient),
        # odd fields negate (v = 0 on the wall rows is set by _zero_wall_v)
        return torch.cat([parity * a[:, 1:2], a, parity * a[:, -2:-1]], dim=1)

    def ddy(a, parity):
        ag = _ghost(a, parity)
        return (ag[:, 2:] - ag[:, :-2]) * inv_2dy

    def lap(a, parity):
        ax = (torch.roll(a, -1, dims=-1) - 2 * a + torch.roll(a, 1, dims=-1)) * inv_dx2
        ag = _ghost(a, parity)
        ay = (ag[:, 2:] - 2 * a + ag[:, :-2]) * inv_dy2
        return ax + ay

    def _zero_wall_v(v):
        v[:, 0] = 0.0
        v[:, -1] = 0.0
        return v

    def rhs(state):
        u, v, eta = state
        du = (-u * ddx(u) - v * ddy(u, 1.0) + f_cor * v - g * ddx(eta)
              + nu * lap(u, 1.0))
        dv = (-u * ddx(v) - v * ddy(v, -1.0) - f_cor * u - g * ddy(eta, 1.0)
              + nu * lap(v, -1.0))
        depth = h0 + eta
        deta = -ddx(depth * u) - ddy(depth * v, -1.0) + nu * lap(eta, 1.0)
        return du, dv, deta

    def rk4(state):
        def axpy(s, k, a):
            return (s[0] + a * k[0], _zero_wall_v(s[1] + a * k[1]), s[2] + a * k[2])

        k1 = rhs(state)
        k2 = rhs(axpy(state, k1, dt / 2))
        k3 = rhs(axpy(state, k2, dt / 2))
        k4 = rhs(axpy(state, k3, dt))
        u = state[0] + dt / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        v = _zero_wall_v(
            state[1] + dt / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]))
        eta = state[2] + dt / 6 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        return u, v, eta

    def record(state):
        for _ in range(steps_per_rec):
            state = rk4(state)
        return state

    # geostrophically balanced initial velocities
    eta = torch.from_numpy(np.asarray(eta0, np.float32)).to(dev)
    g_f = torch.from_numpy(g / f_cor_np).to(dev)
    state = (torch.from_numpy(-(g / f_cor_np)).to(dev) * ddy(eta, 1.0),
             _zero_wall_v(g_f * ddx(eta)), eta)
    for _ in range(spinup_records):
        state = record(state)
    recs = np.empty((ncase, n_records, 3, h, w), np.float32)
    for r in range(n_records):
        state = record(state)
        recs[:, r] = torch.stack(state, dim=1).cpu().numpy()
    if not np.isfinite(recs).all():
        raise FloatingPointError("shallow-water integration blew up")
    u, v, eta = recs[:, :, 0], recs[:, :, 1], recs[:, :, 2]
    pres = g * eta
    return u, v, pres


def make_sw_solver_store(dirpath: str, ncase: int = 64, case_len: int = 88,
                         h: int = 96, w: int = 192, seed: int = 7,
                         test_frac: float = 0.2, fmt: str = "zarr",
                         device=None) -> Tuple[str, str, str]:
    """Generate train / test SW stores and their normstats in the on-disk
    layout the SW datasets read (zarr directories, or npz with
    ``fmt="npz"``, holding u / v / pres [N, T, H, W], chunks (1, T, H, W);
    ``normstats.npz`` of the training split). Returns (train_path,
    test_path, stat_path)."""
    from lns_tpu_torch.data.zarr_reader import write_zarr_array

    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_test = max(2, int(round(ncase * test_frac)))
    eta0 = _initial_eta(rng, ncase + n_test, h, w)
    u, v, p = simulate_sw(eta0, n_records=case_len, device=device)

    paths = []
    splits = (("train", slice(0, ncase)), ("test", slice(ncase, None)))
    stat_path = os.path.join(dirpath, "normstats.npz")
    for split, sl in splits:
        us, vs, ps = u[sl], v[sl], p[sl]
        if fmt == "zarr":
            store = os.path.join(dirpath, f"{split}.zarr")
            os.makedirs(store, exist_ok=True)
            ck = (1, case_len, h, w)
            write_zarr_array(os.path.join(store, "u"), us, chunks=ck)
            write_zarr_array(os.path.join(store, "v"), vs, chunks=ck)
            write_zarr_array(os.path.join(store, "pres"), ps, chunks=ck)
        else:
            store = os.path.join(dirpath, f"{split}.npz")
            np.savez(store, u=us, v=vs, pres=ps)
        paths.append(store)
        if split == "train":
            np.savez(stat_path,
                     u_mean=np.float32(us.mean()), u_std=np.float32(us.std()),
                     v_mean=np.float32(vs.mean()), v_std=np.float32(vs.std()),
                     pres_mean=np.float32(ps.mean()),
                     pres_std=np.float32(ps.std()))
    return paths[0], paths[1], stat_path
