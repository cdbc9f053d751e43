"""The layout probes of the fused FAB design, on the card: each in-kernel
form the TPU probe tried, as the port's kernels do it.

    python3 -m lns_tpu_torch.kernels.probe_layouts

Port of ``benchmarks/probe_mosaic.py``, which asked what Mosaic (Pallas on a
TPU) can express inside one kernel. In bf16 and f32:

  * ``lane_merge_reshape``: [128, 32, 64] -> [128, 2048], and
    ``lane_split_reshape``, the reverse: ``blocked_copy``. On row-major
    memory the relayout is the identity, so the copy is all the work;
  * ``transpose_4d``: [4, 32, 32, 64] with dims 1 and 2 swapped: kernel 7
    (``transpose_hw``) at [1, 4, 32, 32, 64];
  * ``rank3_dot``: [128, 128] . [128, 32, 64], f32 sums: kernel 6
    (``bmm_blockdiag``) at [1, 1, 128, 2048];
  * ``fused_axial``: a row dot rounded to the dtype, [G, H, W, D] -> [G, W,
    H, D], a column dot (G = 4, 32x32, D 64): kernel 6 -> kernel 7 ->
    kernel 6.

Each is held to its plain version with the TPU probe's tolerance (the
reshapes and the transpose exactly; ``rank3_dot`` rtol = atol = 2e-2;
``fused_axial`` rtol 5e-2, atol 5e-1) and prints PASS or FAIL, then its
time by CUDA events and by CUDA-graph replays beside its plain version's
(the library calls: ``clone``, ``contiguous``, ``matmul``). Exits 1 on a
FAIL or where there is no CUDA device. The inputs are seeded normal values
of the TPU probe's shapes (the TPU probe draws them from ``jax.random``).
"""

from __future__ import annotations

import json

import torch

from lns_tpu_torch.kernels import _probe
from lns_tpu_torch.kernels.axial_pipeline import (bmm_blockdiag, bmm_blockdiag_plain,
                                                  transpose_hw, transpose_hw_plain)
from lns_tpu_torch.kernels.blocked_copy import blocked_copy, blocked_copy_plain

G, H, W, D = 4, 32, 32, 64  # the fused probe: 4 heads packed, 128 = G H rows


def _rows(x):
    """[128, ...] as the copy's [B, 1, row]: one sample (row) per block."""
    return x.reshape(x.shape[0], 1, -1)


def forms(kernels: dict):
    """The five probes as functions of their inputs, on `kernels`' copy,
    transpose and product (the kernels or their plain versions)."""
    copy, swap, bmm = kernels["copy"], kernels["transpose"], kernels["bmm"]

    def fused_axial(kx, ky, phi):
        o1 = bmm(kx[None, None], phi[None, None])  # rounded to the dtype
        o1 = swap(o1.reshape(1, G, H, W, D))
        return bmm(ky[None, None], o1.reshape(1, 1, G * W, H * D))[0, 0]

    return {
        "lane_merge_reshape": (lambda x: copy(_rows(x), 1).reshape(128, 2048), ((128, 32, 64),)),
        "lane_split_reshape": (lambda x: copy(_rows(x), 1).reshape(128, 32, 64), ((128, 2048),)),
        "transpose_4d": (lambda x: swap(x[None])[0], ((4, 32, 32, 64),)),
        "rank3_dot": (lambda k, x: bmm(k[None, None], x.reshape(1, 1, 128, 2048))[0, 0]
                      .reshape(128, 32, 64), ((128, 128), (128, 32, 64))),
        "fused_axial": (fused_axial, ((G * H, G * H), (G * W, G * W), (G * H, W * D))),
    }


KERNELS = {"copy": blocked_copy, "transpose": transpose_hw, "bmm": bmm_blockdiag}
PLAIN = {"copy": blocked_copy_plain, "transpose": transpose_hw_plain, "bmm": bmm_blockdiag_plain}
# the TPU probe's tolerances (rtol, atol): the reshapes and the transpose
# exactly, the dots as benchmarks/probe_mosaic.py:99-100 and :129-130
TOL = {"rank3_dot": (2e-2, 2e-2), "fused_axial": (5e-2, 5e-1)}


def run(dev, timed: bool = True, seed: int = 0):
    """Every probe in bf16 and f32 on the kernels, held to the plain
    versions; with `timed`, the kernels' ms by CUDA events and by CUDA-graph
    replays, and the plain version's (its library calls). Returns
    {"<probe>/<dtype>": {"ok", "ms", "device_ms", "library_ms",
    "library_device_ms"}}."""
    gen = torch.Generator().manual_seed(seed)
    kern, plain = forms(KERNELS), forms(PLAIN)
    res = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for name, (fn, shapes) in kern.items():
            args = [torch.randn(*s, generator=gen).to(dev, dt) for s in shapes]
            out, ref = fn(*args), plain[name][0](*args)
            rtol, atol = TOL.get(name, (0.0, None))
            ok = _probe.held(f"{name}/{tag}", out, ref, rtol, atol=atol)
            row = {"ok": ok}
            if timed:
                lib = plain[name][0]
                row["ms"] = _probe.events_ms(lambda: fn(*args))
                row["device_ms"] = _probe.graph_ms(lambda: fn(*args))
                row["library_ms"] = _probe.events_ms(lambda: lib(*args))
                row["library_device_ms"] = _probe.graph_ms(lambda: lib(*args))
                print(f"      {name}/{tag}: {row['ms']:.4f} ms by events, "
                      f"{row['device_ms']:.4f} ms device (graph replays); the plain version's "
                      f"library calls {row['library_ms']:.4f} / {row['library_device_ms']:.4f} ms",
                      flush=True)
            res[f"{name}/{tag}"] = row
    return res


def main() -> int:
    dev, smi = _probe.card("probe_layouts")
    res = run(dev)
    print(json.dumps({"probe": "probe_layouts", "card": smi, "results": res}))
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
