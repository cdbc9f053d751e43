"""What decides ``correct``: the program's outputs for a sample of the
window's predicts against the plain reference, stage by stage.

Random weights make the rollout drift: over 29 steps the program in bf16
and the reference in f32 part by a worst frame of 0.06-0.22 (latents) and
0.14-0.48 (fields) relative L2 on NS2d (CPU, four seeds, PERF.md), about as
far as a lower precision would take them. So the reference follows the
program step by step from the program's own state, and the start and each
stage are checked by themselves:

* ``encoder``: the program's encoder output (the rollout's first carry)
  against the reference's encode of the same input;
* ``step``: every step of the program's rollout against one reference step
  from the program's carry before it (the encoder output for the first);
* ``decoder`` (cells that decode): every decoded frame against the
  reference's decode of the latent the program decoded.

Each number is the worst over the compared rows (a sample at a step) of the
row's relative L2 error, ``||program - reference|| / ||reference||``, float32,
a row that is not finite counting as infinitely far. The reference runs on
the program's outputs only to judge them, in blocks, after the program's
state is freed.
"""

from __future__ import annotations

from typing import Dict, List

import torch

STEP_BLOCK = 2048          # latents per reference step
DECODE_BYTES = 2 ** 28     # f32 bytes of a decoded block's widest activation


def worst_row(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Max over rows (dim 0) of ||prog - ref|| / ||ref||, f32; inf where a
    row of prog is not finite."""
    a, b = prog.float().flatten(1), ref.float().flatten(1)
    err = (a - b).norm(dim=1) / b.norm(dim=1)
    return float(torch.nan_to_num(err, nan=float("inf")).max())


def _blocks(fn, x: torch.Tensor, n: int, *rest: torch.Tensor) -> torch.Tensor:
    """fn over blocks of `n` rows of x and, row for row, of each of `rest`."""
    return torch.cat([fn(*parts) for parts in zip(*(t.split(n) for t in (x,) + rest))])


def _decode_block(widths: dict) -> int:
    """Frames per reference decode block: its widest activation, the field
    at 64 channels in f32, within ``DECODE_BYTES``."""
    return max(1, DECODE_BYTES // (widths["Ly"] * widths["Lx"] * 64 * 4))


def readings(ref, samples, widths: dict) -> Dict[str, float]:
    """The worst row of each stage over `samples` (``harness.Sample``: the
    input, the encoder output, the rollout's latents [b * t or b, t, ...],
    where decoded the frames, and where the model takes it each sample's
    parameter, which every step of the sample is given)."""
    out: Dict[str, float] = {}
    with torch.no_grad():
        for s in samples:
            b = s.x.shape[0]
            zs = s.zs.reshape((b, -1) + tuple(s.z0.shape[1:]))
            carry = torch.cat([s.z0[:, None], zs[:, :-1]], 1).flatten(0, 1)
            cond = () if s.cond is None else (s.cond.repeat_interleave(zs.shape[1]),)
            got = {"encoder": worst_row(s.z0, _blocks(ref.encode, s.x, 256)),
                   "step": worst_row(zs.flatten(0, 1),
                                     _blocks(ref.step, carry, STEP_BLOCK, *cond))}
            if s.y is not None:
                yr = _blocks(ref.decode, zs.flatten(0, 1), _decode_block(widths))
                got["decoder"] = worst_row(s.y.flatten(0, 1), yr)
            for k, v in got.items():
                out[k] = max(out.get(k, 0.0), v)
    return out


def control_samples(ctrl, samples, steps: int, decodes: bool, widths: dict) -> List:
    """The reference in a lower precision put in the program's place: for
    each sample's input (and parameter) its own encode, its own rollout from
    its own carry and its own decode, in the program's layout."""
    from harness import Sample

    out = []
    with torch.no_grad():
        for s in samples:
            cond = () if s.cond is None else (s.cond,)
            z = z0 = ctrl.encode(s.x)
            zs = []
            for _ in range(steps):
                z = _blocks(ctrl.step, z, STEP_BLOCK, *cond)
                zs.append(z)
            zs = torch.stack(zs, 1)
            y = None
            if decodes:
                y = _blocks(ctrl.decode, zs.flatten(0, 1), _decode_block(widths))
                y = y.reshape(zs.shape[:2] + y.shape[1:])
            out.append(Sample(s.index, s.x, z0, zs.flatten(0, 1) if decodes else zs, y, s.cond))
    return out


def check(values: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each number beside its limit, in the limits file's order; a number
    the run did not read counts as infinitely far."""
    return {k: {"value": values.get(k, float("inf")), "limit": lim["limit"]}
            for k, lim in limits.items()}


def passed(checked: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
