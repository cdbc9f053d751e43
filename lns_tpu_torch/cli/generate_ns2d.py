"""Generate an NS2d training corpus with the pseudo-spectral Navier-Stokes
solver (``lns_tpu_torch.data.ns2d_solver``) in the npz layout the NS2d
datasets read (``all_sol_center`` / ``forward`` / ``backward``,
[T, H, W, Ncase]): FNO-regime forced turbulence (GRF initial vorticity,
fixed sinusoidal forcing, visc 1e-4), so both stages can be trained
without an external dataset. Counterpart of the JAX package's
``scripts/generate_ns2d_data.py``, with its flags and defaults:

    python -m lns_tpu_torch.cli.generate_ns2d --out ns2d.npz [--ncase 128]
        [--case-len 30] [--n 64] [--visc 1e-4] [--t-record 1.0]
        [--dt 2.5e-4] [--spinup 10] [--seed 0] [--device cpu]

Runs on the CUDA card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ncase", type=int, default=128)
    p.add_argument("--case-len", type=int, default=30)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--visc", type=float, default=1e-4)
    p.add_argument("--t-record", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=2.5e-4)
    p.add_argument("--spinup", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)

    from lns_tpu_torch.data.ns2d_solver import make_ns2d_solver_npz

    t0 = time.time()
    path = make_ns2d_solver_npz(
        args.out, ncase=args.ncase, case_len=args.case_len, n=args.n,
        visc=args.visc, t_record=args.t_record, seed=args.seed, dt=args.dt,
        spinup_records=args.spinup, device=args.device)
    print(f"wrote {path} ({args.ncase} cases x {args.case_len} frames "
          f"@ {args.n}x{args.n}) in {time.time() - t0:.0f}s")
    return path


if __name__ == "__main__":
    main()
