"""The TPU probe's nineteen dot orientations and FAB chains, on the card.

    python3 -m lns_tpu_torch.kernels.probe_dots [case ...] [--variants]

Port of ``benchmarks/probe_mosaic_dots.py`` (all its cases by default, as its
``main()``), at its shapes (C = 64, H = W = L = I = 32) on seeded
``torch.randn`` inputs in bf16: twelve cases through ``dot_general``, seven
through ``dot_chain`` (``csrc/mosaic_dots.cu``). Per case it prints PASS or
FAIL against the plain version (``tolerance``; a chain's two runs bitwise equal
too), its time by CUDA events and its device time by CUDA-graph replays, the
bound (the case's operations at the H100's bf16 tensor-core and f32 rates,
or its bytes at 3.35 TB/s, whichever is larger) with its share of the device
time, the plain version's time, the library time by events and by graph
replays (one ``torch.einsum`` for a single dot, on f32 copies of the operands
where the output is f32; the plain version's einsum chain for the moments and
the chains), each operand's feed (straight, transposed, staged, or f32 on
the CUDA cores) and a single dot's plan (its block tile, blocks and
cluster). With no case named it then times the handoff of bb three ways at
one sample and head (``handoffs``). With ``--variants`` it times the
``dot_general`` cases, the interior dot (``fab_mega.interior_dot``) and a
sweep of the depth K on the source beside edited copies of
``csrc/mosaic_dots.cu`` (``VARIANTS``: other block-tile rules, a shorter
ring; ``ABLATIONS``: no products, the first k stage's loads only), in
turns, with the einsum at each depth and the launch floor. Ends with one JSON line;
exits 1 on a FAIL or where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from lns_tpu_torch.kernels import _build, _probe
from lns_tpu_torch.kernels.mosaic_dots import (CASES, CHAIN_FEEDS, SHAPES, _letters, dot_general,
                                               dot_general_plain, run_case)

C, S = 64, 32
# operations per chain, (bf16 on tensor cores, f32 on CUDA cores): 2 per
# multiply-add of each product (the elementwise work left out)
_APPLY, _PAIR = 2 * C * S * S * S, 2 * S * S * C * C  # one axial apply; one c -> o product
CHAIN_FLOPS = {
    "apply_chain": (2 * _APPLY + _PAIR, 0),
    "chain_projf_f32": (_PAIR + 2 * _APPLY, 0),
    "chain_moments_f32": (_PAIR + 2 * _APPLY, 0),
    "scr_bf16_f32": (2 * _APPLY + _PAIR, 0),
    "scr_f32_f32": (2 * _APPLY, _PAIR),
    "chain_scr2_f32": (0, 2 * _APPLY + 2 * _PAIR + 2 * C ** 3 + 2 * C * C),
    "transp_chain_f32": (_PAIR, _APPLY),
}
CHAIN_INPUTS = {k: ("u", "k2", "k3", "m") for k in CHAIN_FLOPS}
CHAIN_INPUTS["transp_chain_f32"] = ("q", "m", "k2")

BF16_ULP = 2.0 ** -7  # one bf16 ulp of max|plain| is at most 2^-7 x max|plain|


def tolerance(key):
    """(rel_tol x max|plain|, share of elements that may differ) of a case's
    kernel against its plain version: bf16 outputs of one product one ulp in
    at most 1 % (a sum in another order rounds the other way); f32 outputs
    with no bf16 rounding after a sum 1e-5 (sum order; the tensor cores add
    with their own alignment); the moments 1e-3 (a phi or phi^2 rounded the
    other way moves its column's sum by its ulp); the chains with bf16
    intermediates 1e-2 with at most 2 % differing (a rounding flip
    propagates through the later products)."""
    spec = CASES[key]
    if key in ("apply_chain", "chain_projf_f32", "scr_bf16_f32", "scr_f32_f32"):
        return 1e-2, 0.02 if spec.out_dtype == torch.bfloat16 else 1.0
    if spec.epilogue == "moments" or key == "chain_moments_f32":
        return 1e-3, 1.0
    if spec.out_dtype == torch.bfloat16:
        return BF16_ULP, 0.01
    return 1e-5, 1.0


def inputs(dev, seed: int = 0):
    """The TPU probe's inputs, seeded normal values in bf16, by name."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            for k, shape in SHAPES.items()}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def work(key, x, out):
    """(bf16 FLOP, f32 FLOP, bytes) of one call of case `key`: its products'
    operations, each input read once and the output written once."""
    spec = CASES[key]
    if spec.route == "dot_chain":
        return (*CHAIN_FLOPS[key], _nbytes(*(x[k] for k in CHAIN_INPUTS[key]), out))
    a, b = x[spec.lhs], x[spec.rhs]
    # multiply-adds: out elements x k = a.numel() x (b.numel() / k) / batch
    flops = 2 * a.numel() * (b.numel() // b.shape[spec.contract[1][0]])
    if spec.batch[0]:
        flops //= a.shape[spec.batch[0][0]]
    ins = (a,) if a is b else (a, b)
    return flops, 0, _nbytes(*ins, out)


def bound_ms(bf16_flops, f32_flops, nbytes):
    """The least time on an H100: the operations at their types' peaks, or
    the bytes at the memory rate, whichever is larger; and which."""
    ops = (bf16_flops / _probe.PEAK_BF16 + f32_flops / _probe.PEAK_F32) * 1e3
    by_bytes = nbytes / _probe.PEAK_BYTES * 1e3
    return max(ops, by_bytes), "operations" if ops >= by_bytes else "bytes"


def library(key, x):
    """One PyTorch call of the same function where there is one (a single
    dot: torch.einsum, on f32 copies where the output is f32), else the
    plain version's einsum chain."""
    spec = CASES[key]
    if spec.route == "dot_chain" or spec.epilogue == "moments":
        return lambda: run_case(key, x, plain=True)
    a, b = x[spec.lhs], x[spec.rhs]
    eq = _letters(a, b, spec.contract, spec.batch)
    if spec.epilogue == "sum_batch":
        eq = eq.replace("->n", "->")
    if spec.out_dtype == torch.float32:
        a, b = a.float(), b.float()
    return lambda: torch.einsum(eq, a, b)


def feeds(key, on_card):
    """How the case's operands reached the tensor cores (a chain's per stage)."""
    spec = CASES[key]
    if spec.route == "dot_chain":
        return CHAIN_FEEDS[key]
    if not on_card:
        return "none (the plain version on the CPU)"
    return (f"lhs {spec.lhs} {dot_general.feeds[0]}, rhs {spec.rhs} {dot_general.feeds[1]}; "
            + plan_text())


def plan_text():
    """The last ``dot_general`` launch's block tile, blocks and cluster."""
    plan = dot_general.plan
    if plan is None:
        return "no launch (the plain version on the CPU)"
    return f"tile {plan['tile']}, {plan['blocks']} blocks, cluster {plan['cluster']}"


def run(dev, keys=None, timed: bool = True, seed: int = 0):
    """Each case in `keys` (all by default) on the kernels, held to its plain
    version; with `timed`, a chain's second run bitwise, and every case's
    times, bound and library time. Returns {case: {"ok", "route", "feeds",
    ...}}."""
    x = inputs(dev, seed)
    res = {}
    for key in keys or CASES:
        spec = CASES[key]
        out = run_case(key, x)
        row = {"route": spec.route, "feeds": feeds(key, out.is_cuda)}
        rel, differ = tolerance(key)
        ok = _probe.held(f"{key} ({spec.desc}) {spec.route}", out, run_case(key, x, plain=True),
                         rel, differ)
        print(f"      {key}: feeds {row['feeds']}", flush=True)
        if timed:
            if spec.route == "dot_chain":
                again = torch.equal(out, run_case(key, x))
                print(f"{'PASS' if again else 'FAIL'} {key}: two runs bitwise equal", flush=True)
                ok &= again
            fn = lambda: run_case(key, x)  # noqa: E731
            bound, by = bound_ms(*work(key, x, out))
            lib = library(key, x)
            row.update(ms=_probe.events_ms(fn), device_ms=_probe.graph_ms(fn),
                       plain_ms=_probe.events_ms(lambda: run_case(key, x, plain=True)),
                       library_ms=_probe.events_ms(lib), library_device_ms=_probe.graph_ms(lib),
                       bound_ms=bound, bound_by=by)
            print(f"      {key}: {row['ms']:.4f} ms by events, {row['device_ms']:.4f} ms device "
                  f"(graph replays), bound {bound * 1e3:.3f} us ({by}; "
                  f"{bound / row['device_ms']:.2%} of the device time), plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms by events, "
                  f"{row['library_device_ms']:.4f} ms device", flush=True)
        row["ok"] = ok
        res[key] = row
    return res


def handoffs(dev, seed: int = 1):
    """bb handed from one product to the next three ways, at the one shape
    the designs share (32x32, c 64, one sample, one head, bf16), by device
    ms of CUDA-graph replays: ``dot_chain`` (apply_chain: bb through
    distributed shared memory; chain_scr2_f32: the whole chain with its
    statistics, in f32), ``fab_mega_stats`` + ``fab_mega_apply`` (bb
    recomputed in each pass) and kernel 2 (``fab_fused_core``, d 64: bb
    through a scratch in device memory, four launches). Each computes
    another function; an indication, not a like-for-like comparison."""
    from lns_tpu_torch.kernels.fab_core import fab_fused_core
    from lns_tpu_torch.kernels.fab_mega import fab_mega_apply, fab_mega_stats
    from lns_tpu_torch.kernels.mosaic_dots import dot_chain

    x = inputs(dev, seed)
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    u = x["u"].permute(1, 2, 0).contiguous()[None]  # [1, h, w, c]
    kx, ky = x["k3"][None, None], x["k2"][None, None]
    m, bias = x["m"][None, None], torch.zeros(1, C, device=dev, dtype=bf)
    w_in = (torch.randn(C, 1, C, generator=gen) / C ** 0.5).to(dev)
    w_o1 = (torch.randn(1, C, C, generator=gen) / C ** 0.5).to(dev)
    u_t = u.transpose(1, 2).contiguous()
    forms = {
        "dot_chain apply_chain (bb by DSMEM, 1 launch)":
            lambda: dot_chain("apply_chain", *x.values()),
        "dot_chain chain_scr2_f32 (with the statistics, f32, 1 launch)":
            lambda: dot_chain("chain_scr2_f32", *x.values()),
        "fab_mega_stats + fab_mega_apply (bb recomputed, 2 launches)":
            lambda: (fab_mega_stats(u_t, kx, ky), fab_mega_apply(u_t, kx, ky, m, bias)),
        "kernel 2 fab_fused_core (bb scratch, 4 launches)":
            lambda: fab_fused_core(u.to(bf), kx, ky, w_in, w_o1),
    }
    res = {}
    for label, fn in forms.items():
        res[label] = _probe.graph_ms(fn)
        print(f"      handoff: {label}: {res[label]:.4f} ms device (graph replays)", flush=True)
    return res


# edited copies of csrc/mosaic_dots.cu (pairs for _probe.use_copy) that
# --variants times beside the source: two other block-tile rules (tile_of's
# grid target) and a ring of two stages, each held to the plain version
_WANT = "  const long long want = std::min<long long>(kFill, blocks(32, 32));"
VARIANTS = {
    # the largest tile a side allows: 64 x 64 unless a side is 32 or less
    "largest tile": [(_WANT, "  const long long want = 1;")],
    # half the grid of 32 x 32 tiles: 64 x 32 or 32 x 64 at the probe's shapes
    "half the 32x32 grid": [(_WANT, "  const long long want = std::min<long long>(kFill, "
                                    "(blocks(32, 32) + 1) / 2);")],
    "ring of 2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
}
# and two ablations, timed only (their outputs are wrong by design): what a
# k stage's products and its loads each cost
_LOADS = ("      pa.load(slot, p.a, bi, m_next, p.m, ik * kKT, p.k);\n"
          "      pb.load(slot + kA, p.b, bi, n0, p.n, ik * kKT, p.k);")
ABLATIONS = {
    "no products": [("for (int nt = 0; nt < NT; ++nt) lns::mma_bf16(acc[mt][nt], af[mt], "
                     "bfr[nt][0], bfr[nt][1]);", "for (int nt = 0; nt < NT; ++nt) {}")],
    "stage 0's loads only": [(_LOADS, "      if (ik == 0) {\n" + _LOADS + "\n      }")],
}
DEPTHS = (32, 64, 128, 256)


def variants(dev, seed: int = 0):
    """Each ``dot_general`` case, the interior dot [32,32] . [32,32,64] and a
    sweep of the depth K (``DEPTHS``, proj_major's transposed x transposed
    orientation and a straight x straight one, m 1024, n 64) on the
    source's library and on each of VARIANTS and ABLATIONS (built by
    ``_probe.use_copy``), timed by CUDA-graph replays in turns (source, the
    copies, the copies reversed, source); every output but an ablation's
    held to the plain version. Also the einsum at each depth and the launch
    floor (``x.add_(1)`` on one element). Returns ({case: {library: [device
    ms, ...]}}, {case: {library: plan}}, ok)."""
    from lns_tpu_torch.kernels.fab_mega import interior_dot, interior_dot_plain

    x = inputs(dev, seed)
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    kx = (torch.randn(32, 32, generator=gen) / 32).to(dev, bf)
    a = torch.randn(32, 32, 64, generator=gen).to(dev, bf)
    runs = {key: (lambda key=key: run_case(key, x), lambda key=key: run_case(key, x, plain=True),
                  tolerance(key)) for key, spec in CASES.items() if spec.route == "dot_general"}
    runs["interior_dot"] = (lambda: interior_dot(kx, a), lambda: interior_dot_plain(kx, a),
                            tolerance("rhs_interior"))
    one = torch.zeros(1, device=dev)
    lib_ms = {"launch floor, x.add_(1) on one element": _probe.graph_ms(lambda: one.add_(1))}
    for k in DEPTHS:
        for label, (p, q, dims) in {
                "transposed": ((k, 32, 32), (k, 64), ((0,), (0,))),
                "straight": ((1024, k), (64, k), ((1,), (1,)))}.items():
            lhs, rhs = (torch.randn(*s, generator=gen).to(dev, bf) for s in (p, q))
            args = (lhs, rhs, dims, ((), ()), bf)
            runs[f"K {k} {label}"] = (lambda args=args: dot_general(*args),
                                      lambda args=args: dot_general_plain(*args), (BF16_ULP, 0.01))
            eq = _letters(lhs, rhs, dims, ((), ()))
            lib_ms[f"K {k} {label} einsum"] = _probe.graph_ms(
                lambda eq=eq, lhs=lhs, rhs=rhs: torch.einsum(eq, lhs, rhs))
    libs = {"source": _build.library()}
    for name, edits in {**VARIANTS, **ABLATIONS}.items():
        _probe.use_copy("probe_dots_" + name.replace(" ", "_").replace("'", ""), "mosaic_dots.cu",
                        edits)
        libs[name] = _build.library()
    order = list(libs) + list(libs)[:0:-1] + ["source"]
    times, plans, ok = {k: {n: [] for n in libs} for k in runs}, {k: {} for k in runs}, True
    for name in order:
        _build._lib = libs[name]
        for key, (fn, plain, (rel, differ)) in runs.items():
            if not times[key][name]:
                out = fn()
                if name not in ABLATIONS:
                    ok &= _probe.held(f"{key} ({name})", out, plain(), rel, differ)
                plans[key][name] = plan_text()
            times[key][name].append(_probe.graph_ms(fn))
    _build._lib = libs["source"]
    for key in runs:
        print(f"      variants {key}: " + "; ".join(
            f"{name} {', '.join(f'{t:.4f}' for t in times[key][name])} ms ({plans[key][name]})"
            for name in libs), flush=True)
    for key, ms in lib_ms.items():
        print(f"      {key}: {ms:.4f} ms device", flush=True)
    return times, plans, lib_ms, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", help="case names to run (default: all)")
    ap.add_argument("--variants", action="store_true",
                    help="time the dot_general cases on edited copies of the source too")
    cli = ap.parse_args()
    unknown = [k for k in cli.cases if k not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}; the cases are {list(CASES)}")
    dev, smi = _probe.card("probe_dots")
    res = run(dev, cli.cases or None)
    slowest = max(res, key=lambda k: res[k]["device_ms"])
    print(f"slowest by device time: {slowest} ({res[slowest]['device_ms']:.4f} ms); {smi}")
    hand = handoffs(dev) if not cli.cases else {}
    ok = all(r["ok"] for r in res.values())
    var = {}
    if cli.variants:  # last: it swaps the library for edited copies
        var["device_ms"], var["plans"], var["library_device_ms"], v_ok = variants(dev)
        ok &= v_ok
    print(json.dumps({"probe": "probe_dots", "card": smi, "results": res, "handoffs": hand,
                      "variants": var}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
