"""Analytic linear-sloshing corpora for the two-phase tank workload (a copy
of ``lns_tpu.data.sloshing_solver``, numpy only).

Writes the reference's on-disk layout (a directory of per-case npz: vel
[T, H, W, 2], prs, vof, freq, depth) from the linear modal solution of a
rectangular tank driven horizontally. Tank width L, depth d, gravity g:
modes k_m = m pi / L with omega_m = sqrt(g k_m tanh(k_m d)); the driving at
Omega = 2 pi freq excites each mode with an amplitude proportional to
1 / (omega_m^2 - Omega^2), plus small free components at omega_m; the
velocity comes from each mode's potential in the liquid, the pressure is
hydrostatic plus its linear dynamic part, and vof a smoothed step at the
interface. Each case carries a random response scale and driving phase.
The same seed gives the same bytes as the JAX package's copy.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

G = 9.81


def _case_fields(rng: np.random.Generator, freq: float, depth: float,
                 t_frames: np.ndarray, h: int, w: int, tank_len: float = 2.0,
                 n_modes: int = 3, eta_amp: float = 0.1):
    """One case: vel [T, H, W, 2], prs [T, H, W], vof [T, H, W]. Rows are y
    (0 at the bottom, up to just above the rest surface), columns x."""
    y_top = depth * (1.0 + 3.5 * eta_amp)  # headroom for the interface
    y = np.linspace(0.0, y_top, h)[:, None]          # [h, 1]
    x = np.linspace(0.0, tank_len, w)[None, :]       # [1, w]
    omega_d = 2 * np.pi * freq

    ks = np.pi * np.arange(1, n_modes + 1) / tank_len
    omegas = np.sqrt(G * ks * np.tanh(ks * depth))

    # forced response per mode ~ 1 / (omega_m^2 - Omega^2), random scale
    resp = 1.0 / (omegas**2 - omega_d**2)
    resp = resp / (np.abs(resp).max() + 1e-12)
    scale = eta_amp * depth * rng.uniform(0.6, 1.4)
    phi_d = rng.uniform(0, 2 * np.pi)

    # small free oscillations at the natural frequencies
    free_amp = scale * 0.2 * rng.uniform(0.3, 1.0, n_modes)
    phi_f = rng.uniform(0, 2 * np.pi, n_modes)

    T = len(t_frames)
    vel = np.zeros((T, h, w, 2), np.float32)
    prs = np.zeros((T, h, w), np.float32)
    vof = np.zeros((T, h, w), np.float32)
    eps = 1.8 * (y_top / (h - 1))  # interface smoothing ~ 1.8 px

    for ti, t in enumerate(t_frames):
        eta = np.zeros((1, w))
        vx = np.zeros((h, w))
        vy = np.zeros((h, w))
        pdyn = np.zeros((h, w))
        for m in range(n_modes):
            k = ks[m]
            # driven component sin(Omega t + phi) and free sin(omega_m t + phi_m)
            for amp, w_t, ph in ((scale * resp[m], omega_d, phi_d),
                                 (free_amp[m], omegas[m], phi_f[m])):
                s_t = np.sin(w_t * t + ph)
                c_t = np.cos(w_t * t + ph)
                eta += amp * np.cos(k * x) * s_t
                # potential -(amp w_t / k) cosh(k y) / sinh(k d) cos(k x) cos(w_t t + ph)
                coef = amp * w_t / np.sinh(k * depth)
                vx += coef * np.cosh(k * y) * np.sin(k * x) * c_t
                vy += -coef * np.sinh(k * y) * np.cos(k * x) * c_t
                # dynamic pressure rho dPhi/dt (rho = 1)
                pdyn += (amp * w_t**2 / k) * (np.cosh(k * y)
                                              / np.sinh(k * depth)
                                              ) * np.cos(k * x) * s_t
        surf = depth + eta                        # [1, w] -> broadcast
        liquid = 1.0 / (1.0 + np.exp(-(surf - y) / eps))
        vof[ti] = liquid
        vel[ti, ..., 0] = vx * liquid
        vel[ti, ..., 1] = vy * liquid
        prs[ti] = (G * np.maximum(surf - y, 0.0) + pdyn) * liquid
    # Dirichlet walls, as in the reference's processed corpus
    vel[:, 0] = vel[:, -1] = 0.0
    vel[:, :, 0] = vel[:, :, -1] = 0.0
    return vel, prs, vof


def make_sloshing_dir(path: str, ncase: int = 48, case_len: int = 79,
                      h: int = 61, w: int = 121, seed: int = 3,
                      dt_frame: float = 0.15,
                      freq_range: Tuple[float, float] = (0.3, 0.9),
                      vary: str = "freq") -> str:
    """Write a per-case npz directory in the reference layout; returns
    `path`.

    vary='freq': fixed depth, a driving frequency per case (the conditional
    corpus; freq stored per case); vary='depth': a fixed frequency and a
    water depth per case (the non-conditional "varying height" corpus).
    Frequencies are drawn outside a +/-10 % band around the first mode's
    resonance, so the linear response stays bounded."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t_frames = np.arange(case_len) * dt_frame
    tank_len = 2.0

    k1 = np.pi / tank_len
    for i in range(ncase):
        if vary == "freq":
            depth = 1.0
            f_res = np.sqrt(G * k1 * np.tanh(k1 * depth)) / (2 * np.pi)
            while True:
                freq = rng.uniform(*freq_range)
                if abs(freq - f_res) > 0.1 * f_res:
                    break
        else:
            depth = rng.uniform(0.6, 1.3)
            freq = 0.35  # fixed, well below every mode's resonance
        vel, prs, vof = _case_fields(rng, freq, depth, t_frames, h, w,
                                     tank_len=tank_len)
        np.savez(os.path.join(path, f"case_{i:04d}.npz"),
                 vel=vel, prs=prs, vof=vof, freq=np.float32(freq),
                 depth=np.float32(depth))
    return path
