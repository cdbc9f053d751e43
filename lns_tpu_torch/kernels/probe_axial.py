"""Time kernels 4 and 5 (``csrc/axial.cu``), kernel 2 (``csrc/fab_core.cu``),
``blocked_copy`` (``csrc/blocked_copy.cu``), ``fab_mega_stats`` and
``fab_mega_apply`` (``csrc/fab_mega.cu``), the seven ``dot_chain`` chains and
the twelve ``dot_general`` cases (``csrc/mosaic_dots.cu``) and the interior
dot (``fab_mega.interior_dot``) of one source tree on the card, for comparing
two trees on one card.

    python3 lns_tpu_torch/kernels/probe_axial.py [--tree DIR] [--label NAME]
        [--only NAME,...] [--save FILE]

``--tree`` is the root of the checkout whose ``lns_tpu_torch`` is timed
(default: the one this file is in), so an older tree is timed with this
script unchanged; each tree builds its own kernel library. Per shape it
prints the mean time of one call by CUDA events over back-to-back calls
(the host's launch pace included, as ``chip_smoke.py``'s ``ms``) and the
device time by CUDA-graph replays (20 calls in one graph, the host's cost
taken out), then one JSON line with the card's name and power limit. Run
trees in turns (parent, change, change, parent) in one call of the card.
``--only`` keeps the cases whose names start with one of the names given
(``blocked_copy``, ``fab_mega_stats``, ``fab_mega_apply``, ``dot_chain``,
``dot_general``, ``interior_dot``, ...). The copy runs at ``probe_bw``'s
shape, [928, 2, 128, 2048] bf16, for each s of its sweep, the two passes at
``probe_fab_mega``'s, b116 n8 32x32 c64, the chains and the single dots
(``dot_general <case>``, ``mosaic_dots.run_case``) at ``probe_dots``' (C
64, 32x32) and the interior dot at [32,32] . [32,32,64]; all through their
wrappers, which take the same arguments in every tree that has them, on
inputs seeded the same way in every tree. ``--save`` writes each case's
output of one call (``torch.save``, on the CPU) for comparing two trees'
bits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--save", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("probe_axial: no CUDA device", file=sys.stderr)
        return 1
    from lns_tpu_torch.kernels import _build, axial, blocked_copy, fab_core, fab_mega, mosaic_dots

    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def events_ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, calls=20, reps=3):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
        g.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * calls)

    def axial_inputs(g_shape, h, w, d):
        kx = (torch.randn(*g_shape, h, h, generator=gen) / h ** 0.5).to(dev, bf)
        ky = (torch.randn(*g_shape, w, w, generator=gen) / w ** 0.5).to(dev, bf)
        return kx, ky, torch.randn(*g_shape, h, w, d, generator=gen).to(dev, bf)

    def fab_inputs(b, h, w, c, n=8, d=64):
        return (torch.randn(b, h, w, c, generator=gen).to(dev, bf),
                (torch.randn(b, n, h, h, generator=gen) / h).to(dev, bf),
                (torch.randn(b, n, w, w, generator=gen) / w).to(dev, bf),
                (torch.randn(c, n, d, generator=gen) / c ** 0.5).to(dev),
                (torch.randn(n, d, c, generator=gen) / d ** 0.5).to(dev))

    cases = []
    for b, n, h, w, d in ((32, 8, 16, 16, 64), (116, 8, 32, 32, 64)):
        kx, ky, phi = axial_inputs((b, n), h, w, d)
        cases.append((f"fab_axial_in_fused bf16 [{b},{n},{h},{w},{d}] IN",
                      lambda kx=kx, ky=ky, phi=phi: axial.fab_axial_in_fused(kx, ky, phi)))
    for g, h, w, d in ((256, 16, 16, 64), (928, 32, 32, 64)):
        kx, ky, phi = axial_inputs((g,), h, w, d)
        cases.append((f"axial_kernel_apply_headmajor bf16 [{g},{h},{w},{d}]",
                      lambda kx=kx, ky=ky, phi=phi: axial.axial_kernel_apply_headmajor(kx, ky, phi)))
    for b, h, w, c in ((116, 16, 16, 64), (116, 32, 32, 64), (4, 24, 48, 64), (2, 48, 96, 64)):
        a = fab_inputs(b, h, w, c)
        cases.append((f"fab_core bf16 b{b} {h}x{w} c{c}",
                      lambda a=a: fab_core.fab_fused_core(*a)))
    x = torch.randn(928, 2, 128, 2048, generator=gen).to(dev, bf)
    for s in (2, 4, 8, 16, 29, 58):
        cases.append((f"blocked_copy bf16 [928,2,128,2048] s={s}",
                      lambda s=s: blocked_copy.blocked_copy(x, s)))
    u_t, kx, ky = fab_inputs(116, 32, 32, 64)[:3]
    cases.append(("fab_mega_stats bf16 b116 n8 32x32 c64",
                  lambda: fab_mega.fab_mega_stats(u_t, kx, ky)))
    m = (torch.randn(116, 8, 64, 64, generator=gen) / 64).to(dev, bf)
    bias = torch.randn(116, 64, generator=gen).to(dev, bf)
    cases.append(("fab_mega_apply bf16 b116 n8 32x32 c64",
                  lambda: fab_mega.fab_mega_apply(u_t, kx, ky, m, bias)))
    xs = {k: torch.randn(shape, generator=gen).to(dev, bf)
          for k, shape in mosaic_dots.SHAPES.items()}
    for chain in mosaic_dots.CHAINS:
        cases.append((f"dot_chain {chain}",
                      lambda chain=chain: mosaic_dots.dot_chain(chain, *xs.values())))
    for key, spec in mosaic_dots.CASES.items():
        if spec.route == "dot_general":
            cases.append((f"dot_general {key}", lambda key=key: mosaic_dots.run_case(key, xs)))
    ikx = (torch.randn(32, 32, generator=gen) / 32).to(dev, bf)
    ia = torch.randn(32, 32, 64, generator=gen).to(dev, bf)
    cases.append(("interior_dot [32,32] . [32,32,64]", lambda: fab_mega.interior_dot(ikx, ia)))
    only = tuple(filter(None, args.only.split(",")))
    out, saved = {}, {}
    for name, fn in cases:
        if only and not name.startswith(only):
            continue
        if args.save:
            r = fn()
            saved[name] = tuple(t.cpu() for t in r) if isinstance(r, tuple) else r.cpu()
        ev, dv = events_ms(fn), graph_ms(fn)
        out[name] = {"events_ms": ev, "device_ms": dv}
        print(f"{args.label} {name}: {ev:.4f} ms by events, {dv:.4f} ms device (graph)", flush=True)
    if args.save:
        torch.save(saved, args.save)
    print(json.dumps({"label": args.label, "tree": os.path.abspath(args.tree), "card": smi,
                      "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
