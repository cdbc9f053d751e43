"""The FAB core without its bb scratch, on the card: the in-kernel forms of a
fused apply pair, and the statistics and apply passes that recompute bb.

    python3 -m lns_tpu_torch.kernels.probe_fab_mega

Port of ``benchmarks/probe_fab_mega.py`` at its shape (b 116, 8 heads,
32x32, c 64, bf16). It prints:

  * the pieces, each held to its plain version: A, the interior rank-3 dot
    ``kx [i, h] . a [l, h, c]`` (``interior_dot``); B, the swap of a's first
    two dims (kernel 7, ``transpose_hw``, at [1, 1, 32, 32, 64]); C and D,
    the collapse [l, h, c] -> [(l h), c] and the split [l, h c] -> [l, h, c]
    (``blocked_copy``: on row-major memory the relayout is the identity);
    B2, swap + collapse + dot, which is A's function with A's output memory
    (``interior_dot`` viewed as [i, (l c)]);
  * the statistics pass (``fab_mega_stats``: G within 1e-3 x max|plain|,
    s too) and the apply pass (``fab_mega_apply``: 1e-2 x max|plain|, at
    most 2 % of the elements differing), each timed by CUDA events and by
    CUDA-graph replays beside its bound, its plain version and the torch
    einsum chain of the TPU probe's ``xla_stats`` / ``xla_full`` (the
    library calls);
  * beside them kernel 2 (``fab_fused_core``, the FAB core the models run)
    at 32x32 b116 (8 heads, d 64): its total time and the device ms of its
    statistics and output passes. Kernel 2 computes another function (w_in,
    the normalisation, a bb scratch it writes once and reads back), so this
    only indicates what recomputing bb in place of storing it costs.

Exits 1 on a FAIL or where there is no CUDA device.
"""

from __future__ import annotations

import json

import torch

from lns_tpu_torch.kernels import _probe
from lns_tpu_torch.kernels.axial_pipeline import transpose_hw, transpose_hw_plain
from lns_tpu_torch.kernels.blocked_copy import blocked_copy, blocked_copy_plain
from lns_tpu_torch.kernels.fab_mega import (fab_mega_apply, fab_mega_apply_plain, fab_mega_stats,
                                            fab_mega_stats_plain, interior_dot,
                                            interior_dot_plain)

B, N, H, W, C = 116, 8, 32, 32, 64
D = 64  # kernel 2's head width


def pieces(kernels: dict):
    """The five pieces as functions of (a3 [H, W, C], kx [H, H], a2 [H, W C])
    on `kernels`' dot, swap and copy (the kernels or their plain versions)."""
    dot, swap, copy = kernels["dot"], kernels["swap"], kernels["copy"]
    return {
        "A rank3-dot interior": lambda a3, kx, a2: dot(kx, a3),
        "B swapaxes(0,1) [l,h,c]": lambda a3, kx, a2: swap(a3[None, None])[0, 0],
        "C leading-collapse -> [(l h), c]":
            lambda a3, kx, a2: copy(a3.reshape(H, 1, W * C), 1).reshape(H * W, C),
        "D minor-split [l, h*c] -> [l, h, c]":
            lambda a3, kx, a2: copy(a2.reshape(H, 1, W * C), 1).reshape(H, W, C),
        "B2 swap+collapse+dot": lambda a3, kx, a2: dot(kx, a3).reshape(H, W * C),
    }


KERNELS = {"dot": interior_dot, "swap": transpose_hw, "copy": blocked_copy}
PLAIN = {"dot": interior_dot_plain, "swap": transpose_hw_plain, "copy": blocked_copy_plain}
# the pieces that compute a dot are held as the apply pass; the rest move data
DOTS = ("A rank3-dot interior", "B2 swap+collapse+dot")


def inputs(dev, seed: int = 0):
    """u [B, h, w, c], u_t (h and w swapped), kx, ky, m [B, N, c, c] and bias
    [B, c], bf16, scaled as the TPU probe scales them."""
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    u = torch.randn(B, H, W, C, generator=gen).to(dev, bf)
    kx = (torch.randn(B, N, H, H, generator=gen) / H).to(dev, bf)
    ky = (torch.randn(B, N, W, W, generator=gen) / W).to(dev, bf)
    m = (torch.randn(B, N, C, C, generator=gen) / C).to(dev, bf)
    bias = torch.randn(B, C, generator=gen).to(dev, bf)
    return u, u.transpose(1, 2).contiguous(), kx, ky, m, bias


def einsum_stats(u, kx, ky):
    """The TPU probe's ``xla_stats`` as torch einsums in bf16 (G and s in
    f32): the library calls of the statistics pass."""
    a = torch.einsum("bnlw,bhwc->bnhlc", ky, u)
    bb = torch.einsum("bnih,bnhlc->bnilc", kx, a).float()
    return torch.einsum("bnilc,bnile->bnce", bb, bb), bb.sum((2, 3))


def einsum_full(u, kx, ky, m, bias):
    """The TPU probe's ``xla_full`` (its output): the library calls of the
    apply pass."""
    a = torch.einsum("bnlw,bhwc->bnhlc", ky, u)
    bb = torch.einsum("bnih,bnhlc->bnilc", kx, a)
    return torch.einsum("bnilc,bnco->bilo", bb, m) - bias[:, None, None, :]


def _timed(label, fn, flops, nbytes):
    ms, dev_ms = _probe.events_ms(fn), _probe.graph_ms(fn)
    bound = max(flops / _probe.PEAK_BF16, nbytes / _probe.PEAK_BYTES) * 1e3
    print(f"      {label}: {ms:.4f} ms by events, {dev_ms:.4f} ms device, bound {bound:.4f} ms "
          f"({bound / dev_ms:.1%} of the device time)", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "bound_ms": bound}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def run_pieces(dev, timed: bool = True, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    args = (torch.randn(H, W, C, generator=gen).to(dev, bf),
            (torch.randn(H, H, generator=gen) / H).to(dev, bf),
            torch.randn(H, W * C, generator=gen).to(dev, bf))
    kern, plain = pieces(KERNELS), pieces(PLAIN)
    res = {}
    for name, fn in kern.items():
        tol, differ = (1e-2, 0.02) if name in DOTS else (0.0, 1.0)
        res[name] = {"ok": _probe.held(f"piece {name}", fn(*args), plain[name](*args), tol,
                                       differ)}
        if timed:
            res[name].update(ms=_probe.events_ms(lambda: fn(*args)),
                             device_ms=_probe.graph_ms(lambda: fn(*args)))
            print(f"      piece {name}: {res[name]['ms']:.4f} ms by events, "
                  f"{res[name]['device_ms']:.4f} ms device", flush=True)
    return res


def run_passes(dev, timed: bool = True, seed: int = 0):
    """The statistics and apply passes at (B, N, H, W, C) against their plain
    versions; with `timed`, their times, the einsum chains' and kernel 2's."""
    u, u_t, kx, ky, m, bias = inputs(dev, seed)
    res = {}
    g, s = fab_mega_stats(u_t, kx, ky)
    gp, sp = fab_mega_stats_plain(u_t, kx, ky)
    ok = _probe.held("fab_mega_stats G", g, gp, 1e-3)
    ok &= _probe.held("fab_mega_stats s", s, sp, 1e-3)
    res["fab_mega_stats"] = {"ok": ok}
    out = fab_mega_apply(u_t, kx, ky, m, bias)
    res["fab_mega_apply"] = {"ok": _probe.held("fab_mega_apply", out,
                                               fab_mega_apply_plain(u_t, kx, ky, m, bias),
                                               1e-2, 0.02)}
    if not timed:
        return res
    pair = 2 * 2.0 * B * N * H * W * W * C  # the two applies
    gram = 2.0 * B * N * H * W * C * C  # the Gram, or b2 . m
    stats_bytes = _nbytes(u_t, kx, ky, g, s)
    apply_bytes = _nbytes(u_t, kx, ky, m, bias, out)
    for label, kernel, plain, lib, nbytes in (
            ("fab_mega_stats", lambda: fab_mega_stats(u_t, kx, ky),
             lambda: fab_mega_stats_plain(u_t, kx, ky), lambda: einsum_stats(u, kx, ky),
             stats_bytes),
            ("fab_mega_apply", lambda: fab_mega_apply(u_t, kx, ky, m, bias),
             lambda: fab_mega_apply_plain(u_t, kx, ky, m, bias),
             lambda: einsum_full(u, kx, ky, m, bias), apply_bytes)):
        row = _timed(f"{label} b{B} n{N} {H}x{W} c{C}", kernel, pair + gram, nbytes)
        row["plain_ms"] = _probe.events_ms(plain)
        row["library_ms"] = _probe.events_ms(lib)
        row["library_device_ms"] = _probe.graph_ms(lib)
        print(f"      {label}: plain {row['plain_ms']:.4f} ms; einsum chain (library) "
              f"{row['library_ms']:.4f} ms by events, {row['library_device_ms']:.4f} ms device",
              flush=True)
        res[label].update(row)
    res["kernel 2"] = kernel2(dev, u, kx, ky)
    return res


def kernel2(dev, u, kx, ky):
    """Kernel 2 at the same u, kx, ky (w_in, w_o1 seeded, 8 heads, d 64, the
    mean from the rounded bb): total time and its passes' device ms. Another
    function than the two passes; an indication of the cost of recomputing
    bb, not a like-for-like comparison."""
    from torch.profiler import ProfilerActivity, profile

    from lns_tpu_torch.kernels.fab_core import fab_fused_core

    gen = torch.Generator().manual_seed(2)
    w_in = (torch.randn(C, N, D, generator=gen) / C ** 0.5).to(dev)
    w_o1 = (torch.randn(N, D, C, generator=gen) / D ** 0.5).to(dev)
    fn = lambda: fab_fused_core(u, kx, ky, w_in, w_o1)  # noqa: E731
    row = {"ms": _probe.events_ms(fn), "device_ms": _probe.graph_ms(fn)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for key in ("fab_block_mean", "fab_bb_stats", "fab_moments", "fab_out"):
            if key in e.key:
                row[key] = row.get(key, 0.0) + e.device_time_total / 5e3
    print(f"      kernel 2 (fab_fused_core, another function: w_in, the normalisation, the bb "
          f"scratch) b{B} {H}x{W} c{C}: {row['ms']:.4f} ms by events, {row['device_ms']:.4f} ms "
          "device; passes " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                         if k.startswith("fab_")), flush=True)
    return row


def main() -> int:
    dev, smi = _probe.card("probe_fab_mega")
    res = {"pieces": run_pieces(dev), "passes": run_passes(dev)}
    print(json.dumps({"probe": "probe_fab_mega", "card": smi, "results": res}))
    ok = all(r["ok"] for part in res.values() for r in part.values() if "ok" in r)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
