"""Pseudo-spectral 2D incompressible Navier-Stokes solver in vorticity form
(counterpart of ``lns_tpu.data.ns2d_solver``): the NS2d corpus generator.

FNO-style forced turbulence on the periodic unit square: a Gaussian random
field for the initial vorticity, the forcing 0.1 (sin 2 pi (x+y) + cos 2 pi
(x+y)), Fourier pseudo-spectral derivatives with 2/3-rule dealiasing,
Crank-Nicolson for the viscous term and explicit Euler for the advective
one. The written npz has the reference's layout (``all_sol_center`` /
``forward`` / ``backward``, [T, H, W, Ncase], f32), which ``NS2DStage1``
and ``NS2DStage2`` read.

The spectral state is complex64 on the device, stepped in the JAX
function's operator order; every constant array is formed in numpy as the
JAX closure forms it (there, folded into the program at trace time) and
then moved to the device. One record interval runs as a loop of eager
steps, and each record is copied to the host as f32. It runs on the CUDA
card unless given ``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def gaussian_random_field(rng: np.random.Generator, n: int, ncase: int,
                          alpha: float = 2.5, tau: float = 7.0) -> np.ndarray:
    """Periodic GRF samples [ncase, n, n] f32 with spectral density
    ~ tau^(2(alpha-1)) (4 pi^2 |k|^2 + tau^2)^(-alpha) (the FNO initial
    measure N(0, 7^(3/2) (-Delta + 49 I)^(-2.5))); numpy on the host, the
    JAX package's function bitwise."""
    kfreq = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky = np.meshgrid(kfreq, kfreq, indexing="ij")
    k2 = 4 * np.pi**2 * (kx**2 + ky**2)
    amp = tau ** (alpha - 1.0) * (k2 + tau**2) ** (-alpha / 2.0)
    amp[0, 0] = 0.0  # zero-mean field
    noise = rng.normal(size=(ncase, n, n))
    w_hat = np.fft.fft2(noise) * amp[None] * n  # n: unit-variance white noise
    return np.real(np.fft.ifft2(w_hat)).astype(np.float32)


def solver_device(device, who: str) -> torch.device:
    """`device`, the CUDA card when None; raises where there is no card
    and the caller did not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device=\"cpu\" to run on the CPU")
    return dev


def spectral_step(n: int, visc: float, dt: float, device):
    """One Crank-Nicolson / explicit-advection step of the spectral
    vorticity w_hat [ncase, n, n // 2 + 1] complex64 on `device`, as the JAX
    function's ``step``: every constant formed in numpy as its closure
    forms them (folded into its program at trace time), then moved."""
    kfreq = np.fft.fftfreq(n, d=1.0 / n)
    kx = kfreq[:, None] * np.ones((1, n // 2 + 1))
    ky = np.ones((n, 1)) * kfreq[None, : n // 2 + 1]
    lap = 4 * np.pi**2 * (kx**2 + ky**2)
    inv_lap = np.where(lap == 0.0, 1.0, lap)
    cutoff = n // 3  # the 2/3-rule dealias mask on the rfft grid
    dealias = ((np.abs(kx) <= cutoff) & (np.abs(ky) <= cutoff)).astype(np.float64)

    xs = np.linspace(0, 1, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = 0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))
    f_hat = np.fft.rfft2(f)

    kx_j = (2j * np.pi * kx).astype(np.complex64)
    ky_j = (2j * np.pi * ky).astype(np.complex64)
    lap_j = lap.astype(np.float32)
    inv_lap_j = inv_lap.astype(np.float32)
    dealias_j = dealias.astype(np.float32)
    f_hat_j = f_hat.astype(np.complex64)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    kx_t, neg_kx_t, ky_t = on(kx_j), on(-kx_j), on(ky_j)
    inv_lap_t, dealias_t = on(inv_lap_j), on(dealias_j)
    dt_f_hat = on(dt * f_hat_j)
    visc_lap = on(0.5 * dt * visc * lap_j)
    cn_den = on(1.0 + 0.5 * dt * visc * lap_j)

    def nonlinear(w_hat):
        psi_hat = w_hat / inv_lap_t
        u = torch.fft.irfft2(ky_t * psi_hat, s=(n, n))
        v = torch.fft.irfft2(neg_kx_t * psi_hat, s=(n, n))
        wx = torch.fft.irfft2(kx_t * w_hat, s=(n, n))
        wy = torch.fft.irfft2(ky_t * w_hat, s=(n, n))
        adv = u * wx + v * wy
        return torch.fft.rfft2(adv) * dealias_t

    def step(w_hat):
        # Crank-Nicolson viscous / explicit advective (the FNO generator's)
        rhs = w_hat - dt * nonlinear(w_hat) + dt_f_hat - visc_lap * w_hat
        return rhs / cn_den

    return step


def simulate_ns2d(w0: np.ndarray, visc: float = 1e-3, t_record: float = 0.5,
                  n_records: int = 30, dt: float = 2.5e-4, device=None) -> np.ndarray:
    """Integrate forced NS vorticity from w0 [ncase, n, n]; returns
    [ncase, n_records, n, n] f32 (the first record at t_record, as the FNO
    data). The advective term is explicit, so dt must keep |u|_max k_max dt
    well below 1 (2.5e-4 at 64^2 is the published generator's 1e-4 at
    256^2). On the card unless `device` names another."""
    dev = solver_device(device, "simulate_ns2d")
    ncase, n, _ = w0.shape
    steps_per_rec = int(round(t_record / dt))
    step = spectral_step(n, visc, dt, dev)
    w_hat = torch.fft.rfft2(torch.from_numpy(np.asarray(w0, np.float32)).to(dev))
    recs = []
    for _ in range(n_records):
        for _ in range(steps_per_rec):
            w_hat = step(w_hat)
        recs.append(torch.fft.irfft2(w_hat, s=(n, n)).float().cpu().numpy())
    return np.stack(recs, axis=1)  # [ncase, n_records, n, n]


def make_ns2d_solver_npz(path: str, ncase: int = 72, case_len: int = 30,
                         n: int = 64, visc: float = 1e-3, t_record: float = 0.5,
                         seed: int = 0, dt: float = 2.5e-4,
                         spinup_records: int = 4, device=None) -> str:
    """Generate an NS2d corpus with the solver and write the reference npz
    layout (dataset/ns2d_fno_stage1.py: [T, H, W, Ncase]; forward /
    backward are the +/-1-record shifts of the same trajectory), after
    `spinup_records` records past the GRF transient. Returns `path`."""
    rng = np.random.default_rng(seed)
    w0 = gaussian_random_field(rng, n, ncase)
    traj = simulate_ns2d(w0, visc=visc, t_record=t_record,
                         n_records=spinup_records + case_len + 2, dt=dt, device=device)
    traj = traj[:, spinup_records:]  # [ncase, case_len + 2, n, n]
    center = traj[:, 1:-1]
    backward = traj[:, :-2]
    forward = traj[:, 2:]
    to_ref = lambda a: np.transpose(a, (1, 2, 3, 0)).astype(np.float32)  # noqa: E731
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, all_sol_center=to_ref(center), all_sol_forward=to_ref(forward),
             all_sol_backward=to_ref(backward))
    return path
