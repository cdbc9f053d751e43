"""The FAB core without its bb scratch, on the card: the in-kernel forms of a
fused apply pair, and the statistics and apply passes that recompute bb.

    python3 -m lns_tpu_torch.kernels.probe_fab_mega [--variants] [--phases]

Port of ``benchmarks/probe_fab_mega.py`` at its shape (b 116, 8 heads,
32x32, c 64, bf16). It prints:

  * the pieces, each held to its plain version: A, the interior rank-3 dot
    ``kx [i, h] . a [l, h, c]`` (``interior_dot``, one orientation of
    ``mosaic_dots.dot_general``); B, the swap of a's first
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
    library calls, by events and by graph replays);
  * beside them kernel 2 (``fab_fused_core``, the FAB core the models run)
    at 32x32 b116 (8 heads, d 64): its total time and the device ms of its
    statistics and output passes. Kernel 2 computes another function (w_in,
    the normalisation, a bb scratch it writes once and reads back), so this
    only indicates what recomputing bb in place of storing it costs;
  * both passes and kernel 2's statistics and output passes by
    ``torch.profiler``'s device time per launch, L2-warm (back to back:
    u_t's 15.2 MB stays in the 50 MB L2) and with the L2 flushed before
    each launch;
  * with ``--variants``, the apply pass as the source has it beside edited
    copies (``VARIANTS``: its tile of 16 columns l against 8, step 1 in
    batches of 8 h against 4), device ms in turns;
  * with ``--phases``, both passes by phase (``phases``: a copy of the
    sources with ``clock64()`` marks, as ``probe_fab_core.py`` marks
    kernel 2).

Exits 1 on a FAIL or where there is no CUDA device. An earlier tree's
passes are timed beside this one's by ``probe_axial.py --tree``.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from lns_tpu_torch.kernels import _build, _probe
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
            lib = ""
            if name in DOTS:  # the library call of the interior dot: one einsum
                einsum = lambda: torch.einsum("ih,lhc->ilc", args[1], args[0])  # noqa: E731
                res[name].update(library_ms=_probe.events_ms(einsum),
                                 library_device_ms=_probe.graph_ms(einsum))
                lib = (f"; einsum {res[name]['library_ms']:.4f} ms by events, "
                       f"{res[name]['library_device_ms']:.4f} ms device")
            print(f"      piece {name}: {res[name]['ms']:.4f} ms by events, "
                  f"{res[name]['device_ms']:.4f} ms device{lib}", flush=True)
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
    res["passes by profiler"] = profiled_passes(dev, u, u_t, kx, ky, m, bias)
    return res


def _kernel2_fn(dev, u, kx, ky):
    """Kernel 2 at u, kx, ky with w_in, w_o1 seeded (8 heads, d 64, the mean
    from the rounded bb)."""
    from lns_tpu_torch.kernels.fab_core import fab_fused_core

    gen = torch.Generator().manual_seed(2)
    w_in = (torch.randn(C, N, D, generator=gen) / C ** 0.5).to(dev)
    w_o1 = (torch.randn(N, D, C, generator=gen) / D ** 0.5).to(dev)
    return lambda: fab_fused_core(u, kx, ky, w_in, w_o1)


def kernel2(dev, u, kx, ky):
    """Kernel 2 at the same u, kx, ky: total time and its passes' device ms.
    Another function than the two passes; an indication of the cost of
    recomputing bb, not a like-for-like comparison."""
    fn = _kernel2_fn(dev, u, kx, ky)
    row = {"ms": _probe.events_ms(fn), "device_ms": _probe.graph_ms(fn),
           **_probe.kernel_ms(fn, ("fab_block_mean", "fab_bb_stats", "fab_moments", "fab_out"))}
    print(f"      kernel 2 (fab_fused_core, another function: w_in, the normalisation, the bb "
          f"scratch) b{B} {H}x{W} c{C}: {row['ms']:.4f} ms by events, {row['device_ms']:.4f} ms "
          "device; passes " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                         if k.startswith("fab_")), flush=True)
    return row


def profiled_passes(dev, u, u_t, kx, ky, m, bias):
    """Device ms per launch of the passes at one shape, L2-warm and with the
    L2 flushed before each launch: ``fab_mega_stats`` and ``fab_mega_apply``
    (a block per sample, wgmma), kernel 2's ``fab_bb_stats`` (which also
    writes bb to its scratch) and ``fab_out``."""
    k2 = _kernel2_fn(dev, u, kx, ky)
    runs = {"fab_mega_stats (wgmma)": (lambda: fab_mega_stats(u_t, kx, ky),
                                       "fab_mega_stats_wgmma"),
            "fab_mega_apply (wgmma)": (lambda: fab_mega_apply(u_t, kx, ky, m, bias),
                                       "fab_mega_apply_wgmma"),
            "kernel 2 fab_bb_stats": (k2, "fab_bb_stats"),
            "kernel 2 fab_out": (k2, "fab_out")}
    out = {}
    for label, (fn, key) in runs.items():
        warm = _probe.kernel_ms(fn, (key,))[key]
        cold = _probe.kernel_ms(fn, (key,), flush=True)[key]
        out[label] = {"device_ms_l2_warm": warm, "device_ms_l2_flushed": cold}
        print(f"      pass {label} b{B} n{N} {H}x{W} c{C}: {warm:.4f} ms device "
              f"L2-warm, {cold:.4f} ms with the L2 flushed before each launch", flush=True)
    return out


# the statistics pass by phase: (anchor, replacement) pairs of csrc/fab_mega.cu
# that add clock64() marks; each warp sums the cycles between marks in
# registers and adds them to g_phase once at the end
PHASES = ["kx, ky waits", "u waits", "step 1", "tile barrier 1", "step 2",
          "b2 and the Gram", "tile barrier 2", "epilogue"]
MARKS = [
    ("constexpr int kWG = 2; ",
     "__device__ unsigned long long g_phase[16];\n"
     "#define MARK(i) do { const long long c_ = clock64(); ph[i] += c_ - ph_last; "
     "ph_last = c_; } while (0)\nconstexpr int kWG = 2; "),
    ("                                           float& s0, float& s1, int wg, int wt) {",
     "                                           float& s0, float& s1, int wg, int wt,\n"
     "                                           long long (&ph)[8], long long& ph_last) {"),
    ("    tc_step2(pb, kx_b, acc);\n    lns::wgmma_wait<0>();\n"
     "    tc_gram(pb, acc, gacc, s0, s1, wg, wt);\n    lns::wgmma_wait<0>();",
     "    tc_step2(pb, kx_b, acc);\n    lns::wgmma_wait<0>();\n    MARK(4);\n"
     "    tc_gram(pb, acc, gacc, s0, s1, wg, wt);\n    lns::wgmma_wait<0>();\n    MARK(5);"),
    ("  for (int hn = 0; hn < n; ++hn) {\n    const int kb = hn & 1;",
     "  long long ph[8] = {}, ph_last = clock64();\n"
     "  for (int hn = 0; hn < n; ++hn) {\n    const int kb = hn & 1;"),
    ("    lns::mbar_wait(&kfull[kb], (hn >> 1) & 1);",
     "    lns::mbar_wait(&kfull[kb], (hn >> 1) & 1);\n    MARK(0);"),
    ("        tc_step1<kTL, kHB>(u_s, ky_b + t * kTL * 128, a_s, (2 * it + wg) * kSlab, wt);",
     "        MARK(1);\n"
     "        tc_step1<kTL, kHB>(u_s, ky_b + t * kTL * 128, a_s, (2 * it + wg) * kSlab, wt);\n"
     "        MARK(2);"),
    ("      lns::bar_sync(1, 128 * kWG);\n      tc_columns(a_s, kx_b, gacc, s0, s1, wg, wt);\n"
     "      lns::bar_sync(1, 128 * kWG);",
     "      lns::bar_sync(1, 128 * kWG);\n      MARK(3);\n"
     "      tc_columns(a_s, kx_b, gacc, s0, s1, wg, wt, ph, ph_last);\n"
     "      lns::bar_sync(1, 128 * kWG);\n      MARK(6);"),
    ("        s_out[bn * kC + r0 + 8] = s1 + s_st[r0 + 8];\n      }\n    }\n  }\n}",
     "        s_out[bn * kC + r0 + 8] = s1 + s_st[r0 + 8];\n      }\n    }\n    MARK(7);\n  }\n"
     "  if (lane == 0) {\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(&g_phase[i], (unsigned long long)ph[i]);\n"
     "    atomicAdd(&g_phase[8], 1ull);\n  }\n}"),
]
# the apply pass by phase, the same way (its own counters, g_aphase; the
# MARK macro comes with MARKS)
APPLY_PHASES = ["slot waits", "u waits", "step 1", "step 1 barrier",
                "kx fragments and the first step 2", "b2 . m and the next step 2",
                "iteration barrier", "epilogue"]
APPLY_MARKS = [
    ("constexpr int kKRing = 2; ",
     "__device__ unsigned long long g_aphase[16];\nconstexpr int kKRing = 2; "),
    ("                                               const uint8_t* m_s, float (&acc)[P][32]) {",
     "                                               const uint8_t* m_s, float (&acc)[P][32],\n"
     "                                               long long (&ph)[8], long long& ph_last) {"),
    ("  lns::wgmma_fence_regs(bb);\n#pragma unroll\n  for (int j = 0; j < P; ++j) {",
     "  lns::wgmma_fence_regs(bb);\n  MARK(4);\n#pragma unroll\n  for (int j = 0; j < P; ++j) {"),
    ("    lns::wgmma_commit();\n    lns::wgmma_wait<0>();\n    lns::wgmma_fence_regs(bb);\n  }\n}",
     "    lns::wgmma_commit();\n    lns::wgmma_wait<0>();\n    lns::wgmma_fence_regs(bb);\n"
     "    MARK(5);\n  }\n}"),
    ("  for (int t = 0; t < kS / TL; ++t) {\n    float acc[TL / 4][32];",
     "  long long ph[8] = {}, ph_last = clock64();\n"
     "  for (int t = 0; t < kS / TL; ++t) {\n    float acc[TL / 4][32];"),
    ("      lns::mbar_wait(&kfull[j % kKRing], (j / kKRing) & 1);",
     "      lns::mbar_wait(&kfull[j % kKRing], (j / kKRing) & 1);\n      MARK(0);"),
    ("        tc_step1<TL, kApplyHB>(u_s, sl + L::kKy, a_s,",
     "        MARK(1);\n        tc_step1<TL, kApplyHB>(u_s, sl + L::kKy, a_s,"),
    ("                               (2 * (it / kPer) + wg) * kSlab + it % kPer * kApplyHB, wt);",
     "                               (2 * (it / kPer) + wg) * kSlab + it % kPer * kApplyHB, wt);\n"
     "        MARK(2);"),
    ("      lns::fence_async_shared();  // a's stores, visible to wgmma\n"
     "      lns::bar_sync(1, kThreadsTc);\n      // this warp's rows",
     "      lns::fence_async_shared();  // a's stores, visible to wgmma\n"
     "      lns::bar_sync(1, kThreadsTc);\n      MARK(3);\n      // this warp's rows"),
    ("      tc_apply_pairs<TL / 4>(a_s + wg * kPair, ka, sl + L::kM, acc);",
     "      tc_apply_pairs<TL / 4>(a_s + wg * kPair, ka, sl + L::kM, acc, ph, ph_last);"),
    ("      if (tid == 0 && j + kKRing < steps) load(j + kKRing);",
     "      if (tid == 0 && j + kKRing < steps) load(j + kKRing);\n      MARK(6);"),
    ("    lns::bar_sync(1, kThreadsTc);  // the output is read before the next tile's step 1\n"
     "  }\n}",
     "    lns::bar_sync(1, kThreadsTc);  // the output is read before the next tile's step 1\n"
     "    MARK(7);\n  }\n  if (lane == 0) {\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(&g_aphase[i], (unsigned long long)ph[i]);\n"
     "    atomicAdd(&g_aphase[8], 1ull);\n  }\n}"),
]
READER = """
extern "C" int lns_fab_mega_phases(unsigned long long* out, int apply) {
  const void* sym = apply ? static_cast<const void*>(g_aphase) : static_cast<const void*>(g_phase);
  cudaError_t e = cudaMemcpyFromSymbol(out, sym, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(sym, z, sizeof z);
  return e;
}
"""


def phases(dev, seed: int = 0):
    """Both passes at (B, N) by phase: a copy of the sources with the marks
    of MARKS and APPLY_MARKS (``_probe.use_copy``) made the library the
    wrappers load; one launch of each after a warm-up one. Prints each
    phase's kilocycles per warp (the sum over a warp's heads, or its tiles
    and heads) and share. Returns {pass: {phase: cycles per warp}}."""
    _probe.use_copy("probe_fab_mega_phases", "fab_mega.cu", MARKS + APPLY_MARKS, READER)
    lib = _build.library()
    lib.lns_fab_mega_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _, u_t, kx, ky, m, bias = inputs(dev, seed)
    res = {}
    for name, names, apply, fn in (
            ("fab_mega_stats", PHASES, 0, lambda: fab_mega_stats(u_t, kx, ky)),
            ("fab_mega_apply", APPLY_PHASES, 1, lambda: fab_mega_apply(u_t, kx, ky, m, bias))):
        buf = (ctypes.c_ulonglong * 16)()
        for _ in range(2):  # the first launch warms up
            fn()
            torch.cuda.synchronize()
            _build.check(lib.lns_fab_mega_phases(buf, apply), "lns_fab_mega_phases")
        warps, total = max(buf[8], 1), sum(buf[i] for i in range(len(names)))
        res[name] = {k: buf[i] / warps for i, k in enumerate(names)}
        print(f"      {name} b{B} n{N} by phase ({buf[8]} warps), kilocycles per warp: "
              + ", ".join(f"{k} {v / 1e3:.1f} ({buf[i] / total:.1%})"
                          for i, (k, v) in enumerate(res[name].items())), flush=True)
    return res


# the apply pass's tile and step-1 batch as edited copies of
# csrc/fab_mega.cu (the source's own are the ones its measurements chose;
# PERF.md)
APPLY_TILE = "constexpr int kApplyTile = 16;"
APPLY_HB = "constexpr int kApplyHB = 8;"
VARIANTS = {"tile 8": [(APPLY_TILE, "constexpr int kApplyTile = 8;")],
            "step-1 batches of 4 h": [(APPLY_HB, "constexpr int kApplyHB = 4;")]}


def variants(dev, seed: int = 0):
    """The apply pass at (B, N) as the source has it and as each of VARIANTS
    (built by ``_probe.use_copy``), device ms by CUDA-graph replays in turns
    (source, variants, variants reversed, source), each held to the plain
    version. Returns ({label: [ms, ms]}, ok)."""
    _, u_t, kx, ky, m, bias = inputs(dev, seed)
    ref = fab_mega_apply_plain(u_t, kx, ky, m, bias)
    libs = {"source": _build.library()}
    for name, edits in VARIANTS.items():
        _probe.use_copy("probe_fab_mega_" + name.replace(" ", "_"), "fab_mega.cu", edits)
        libs[name] = _build.library()
    order = list(libs) + list(libs)[::-1]
    res, ok = {}, True
    for label in order:
        _build._lib = libs[label]
        ok &= _probe.held(f"fab_mega_apply {label}", fab_mega_apply(u_t, kx, ky, m, bias), ref,
                          1e-2, 0.02)
        res.setdefault(label, []).append(_probe.graph_ms(lambda: fab_mega_apply(u_t, kx, ky, m,
                                                                               bias)))
        print(f"      fab_mega_apply b{B} n{N} {label}: {res[label][-1]:.4f} ms device",
              flush=True)
    _build._lib = libs["source"]
    return res, ok


def main() -> int:
    dev, smi = _probe.card("probe_fab_mega")
    res = {"pieces": run_pieces(dev), "passes": run_passes(dev)}
    ok = all(r["ok"] for part in res.values() for r in part.values() if "ok" in r)
    if "--variants" in sys.argv:  # these swap the library for edited copies
        res["variants"], v_ok = variants(dev)
        ok &= v_ok
    if "--phases" in sys.argv:
        res["phases"] = phases(dev)
    print(json.dumps({"probe": "probe_fab_mega", "card": smi, "results": res}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
