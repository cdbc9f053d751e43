"""The work of one predict, counted from the reference architecture at a
cell's sizes, and the least time the card could take for it.

Counts come from the cell's own reference module (``reference/<name>.py``,
the one ``harness.load_reference`` returns; its contract is in
``harness.py``'s docstring), run on the ``meta`` device (shapes, no data),
so they do not change with whatever later computes a layer:

* the model's FLOPs: every conv and matrix product as
  ``torch.utils.flop_counter.FlopCounterMode`` counts it (the factorized
  attention's core in channel space, the form of the port's plain path:
  ``LNS(channel_fab=True)``), for the encode of
  the batch, each propagator step and the decode of every frame; a
  conditional step's conditioning (what depends on ``cond`` alone) once per
  sample of a predict, not once per step;
* per kernel of the program, the calls one predict makes and the bytes and
  operations each needs: kernel 1 (the fused rollout, one call for all
  steps, on the latent grid the meta encode returns), kernel 2 (the
  factorized-attention core, one call per FAB block and decode) and kernel 3
  (GroupNorm + swish, one call per autoencoder GroupNorm).

``Bound``: per call the larger of the operations at the peak rate for their
type and the bytes it must move (each input read once, each output written
once) at the memory rate, summed over calls. The peaks are the H100 SXM's
published dense rates (NVIDIA's data sheet, at its 700 W limit).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
BF16, F32 = 2, 4  # bytes per element


class Bound:
    """The least time the card could take for a kernel's calls."""

    def __init__(self):
        self.s, self.by = 0.0, {}
        self.flops = self.nbytes = 0

    def add(self, flops, nbytes, calls=1, rate=PEAK_BF16):
        self.flops += calls * flops
        self.nbytes += calls * nbytes
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


class _Reads(TorchFunctionMode):
    """Records the names of the tensors of `named` that a torch call
    computes with (reading an attribute such as ``.shape`` is no use)."""

    def __init__(self, named: Dict[str, torch.Tensor]):
        super().__init__()
        self.names, self._by_id = set(), {id(t): k for k, t in named.items()}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") != "__get__":
            self.names.update(self._by_id[id(a)] for a in tree_leaves((args, kwargs))
                              if id(a) in self._by_id)
        return func(*args, **kwargs)


def _meta_model(reference, cfg):
    return reference.LNS(cfg, {k: torch.empty(s, device="meta")
                               for k, s in reference.param_shapes(cfg).items()}, channel_fab=True)


def rollout_work(z: torch.Tensor, steps: int, step_flops: int, weights: int,
                 cond_flops: Optional[int] = None):
    """Kernel 1, one call, for z0 [B, h, w, c]: every step's products; z0,
    the outputs and `weights` (the bytes of the parameters a step reads)
    moved once. A conditional step (`cond_flops` given) adds its
    conditioning's products once per sample, and each sample's parameter
    (f32) read once."""
    b = z.shape[0]
    flops, nbytes = step_flops * b * steps, (1 + steps) * z.numel() * BF16 + weights
    if cond_flops is not None:
        flops, nbytes = flops + cond_flops * b, nbytes + b * F32
    return flops, nbytes


def _weight_bytes(params: Dict[str, torch.Tensor], names) -> int:
    """Matrices and conv taps in bf16, norm parameters and biases in f32."""
    return sum(params[k].numel() * (BF16 if params[k].dim() > 1 else F32) for k in names)


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


def predict_work(reference, cfg, batch: int, steps: int, to_x: bool) -> Dict[str, object]:
    """The model FLOPs of one predict (``flops``, and by part: ``encode``,
    ``step`` per latent, ``conditioning`` per sample, ``decode`` per frame)
    and each kernel's ``Bound`` for one predict (``bounds``: prop_rollout,
    fab_core, group_norm), counted with `reference`'s ``LNS`` on ``meta``;
    an ``LNS`` with ``conditioning`` steps on each sample's parameter."""
    ref = _meta_model(reference, cfg)
    frames = batch * steps
    with FlopCounterMode(display=False) as fc:
        z = ref.encode(torch.empty(batch, cfg["Ly"], cfg["Lx"], cfg["in_channels"], device="meta"))
    enc = fc.get_total_flops()
    cond = hasattr(ref, "conditioning")
    c = (torch.empty(1, device="meta"),) if cond else ()
    cond_flops = _flops(lambda: ref.conditioning(*c)) if cond else None
    with _Reads(ref.p) as reads:
        step = _flops(lambda: ref.step(z[:1], *c)) - (cond_flops or 0)
    calls = list(ref.calls)
    dec = 0
    if to_x:  # one frame's decode, its calls scaled to every frame's
        ref.calls.clear()
        dec = _flops(lambda: ref.decode(z[:1]))
        calls += [("gn", a[0] * frames, a[1]) if k == "gn" else ("fab", frames, *a[1:])
                  for k, *a in ref.calls]
    rollout = rollout_work(z, steps, step, _weight_bytes(ref.p, reads.names), cond_flops)
    bounds = {"prop_rollout": Bound().add(*rollout),
              "fab_core": Bound(), "group_norm": Bound()}
    for call in calls:
        if call[0] == "gn":
            bounds["group_norm"].add(*group_norm_work(call[1], call[2]), rate=PEAK_F32)
        else:
            bounds["fab_core"].add(*fab_work(*call[1:]))
    per_sample = cond_flops or 0
    return {"flops": enc + step * frames + per_sample * batch + dec * frames,
            "encode": enc / batch, "step": step, "conditioning": per_sample, "decode": dec,
            "bounds": bounds}
