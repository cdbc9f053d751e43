"""The work of one predict, counted from the reference architecture at a
cell's sizes, and the least time the card could take for it.

Counts come from ``reference.lns`` alone, run on the ``meta`` device (shapes,
no data), so they do not change with whatever later computes a layer:

* the model's FLOPs: every conv and matrix product as
  ``torch.utils.flop_counter.FlopCounterMode`` counts it (the factorized
  attention's core in channel space, the form of the port's plain path:
  ``LNS(channel_fab=True)``), for the encode of
  the batch, each propagator step and the decode of every frame;
* per kernel of the program, the calls one predict makes and the bytes and
  operations each needs: kernel 1 (the fused rollout, one call for all
  steps), kernel 2 (the factorized-attention core, one call per FAB block
  and decode) and kernel 3 (GroupNorm + swish, one call per autoencoder
  GroupNorm).

``Bound``: per call the larger of the operations at the peak rate for their
type and the bytes it must move (each input read once, each output written
once) at the memory rate, summed over calls. The peaks are the H100 SXM's
published dense rates (NVIDIA's data sheet, at its 700 W limit).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.lns import LNS, param_shapes

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
BF16, F32 = 2, 4  # bytes per element


class Bound:
    """The least time the card could take for a kernel's calls."""

    def __init__(self):
        self.s, self.by = 0.0, {}

    def add(self, flops, nbytes, calls=1, rate=PEAK_BF16):
        ops_s, bytes_s = flops / rate, nbytes / PEAK_BYTES
        by = "operations" if ops_s >= bytes_s else "bytes"
        self.s += calls * max(ops_s, bytes_s)
        self.by[by] = self.by.get(by, 0.0) + calls * max(ops_s, bytes_s)
        return self

    @property
    def bound_by(self):
        return max(self.by, key=self.by.get) if self.by else None


def _flops(fn) -> int:
    """The FLOPs of fn() as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _meta_model(cfg) -> LNS:
    return LNS(cfg, {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()},
               channel_fab=True)


def rollout_work(cfg, batch: int, steps: int, step_flops: int):
    """Kernel 1, one call: every step's products; z0, the outputs and the
    propagator's weights moved once (matrices and conv taps in bf16, norm
    parameters and biases in f32)."""
    h = w = cfg["latent_resolution"]
    if cfg.get("resolutions"):
        w = int(round(h * cfg["resolutions"][1] / cfg["resolutions"][0]))
    weights = sum(math.prod(s) * (BF16 if len(s) > 1 else F32)
                  for k, s in param_shapes(cfg).items() if k.startswith("propagator."))
    return step_flops * batch * steps, (1 + steps) * batch * h * w * cfg["latent_dim"] * BF16 + weights


def fab_work(b, h, w, c, n, d, o):
    """Kernel 2, one call, bf16: per (sample, head) both axial applies, the
    c x c Gram, the output product, the two means and the small products of
    m and E[phi^2]; u, k_x, k_y, the block's input and the GroupNorm's
    coefficients and the kernels' sums (the mean's inputs), w_in (bf16),
    w_o1 (f32) read once and the output written once."""
    flops = 2 * b * n * (h * w * w * c + h * h * w * c + h * w * c * c + h * w * c * o
                         + 2 * h * w * c + c * c * d + c * d * o)
    field = b * h * w * c * BF16
    nbytes = (field + b * n * (h * h + w * w) * BF16 + b * h * w * o * BF16
              + field + b * 2 * c * F32 + b * n * (h + w) * F32 + c * n * d * BF16 + n * d * o * F32)
    return flops, nbytes


def group_norm_work(numel, c):
    """Kernel 3, one call, bf16: 8 f32 operations an element; the slab read
    and written once, the scale and shift (f32) read once."""
    return 8 * numel, 2 * numel * BF16 + 2 * c * F32


def predict_work(cfg, batch: int, steps: int, to_x: bool) -> Dict[str, object]:
    """The model FLOPs of one predict (``flops``, and by part: ``encode``,
    ``step`` per latent, ``decode`` per frame) and each kernel's ``Bound``
    for one predict (``bounds``: prop_rollout, fab_core, group_norm)."""
    ref = _meta_model(cfg)
    frames = batch * steps
    with FlopCounterMode(display=False) as fc:
        z = ref.encode(torch.empty(batch, cfg["Ly"], cfg["Lx"], cfg["in_channels"], device="meta"))
    enc = fc.get_total_flops()
    step = _flops(lambda: ref.step(z[:1]))
    calls = list(ref.calls)
    dec = 0
    if to_x:  # one frame's decode, its calls scaled to every frame's
        ref.calls.clear()
        dec = _flops(lambda: ref.decode(z[:1]))
        calls += [("gn", a[0] * frames, a[1]) if k == "gn" else ("fab", frames, *a[1:])
                  for k, *a in ref.calls]
    bounds = {"prop_rollout": Bound().add(*rollout_work(cfg, batch, steps, step)),
              "fab_core": Bound(), "group_norm": Bound()}
    for call in calls:
        if call[0] == "gn":
            bounds["group_norm"].add(*group_norm_work(call[1], call[2]), rate=PEAK_F32)
        else:
            bounds["fab_core"].add(*fab_work(*call[1:]))
    return {"flops": enc + step * batch * steps + dec * frames, "encode": enc / batch,
            "step": step, "decode": dec, "bounds": bounds}
