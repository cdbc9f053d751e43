#!/usr/bin/env python3
"""Drive the PyTorch port's NS2d inference rollout once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
CUDA PyTorch, Triton and nvcc. It imports nothing of JAX. In order it:

  1. prints the card (torch and nvidia-smi); fails if there is no CUDA card;
  2. builds the CUDA kernels from lns_tpu_torch/csrc (nvcc, sm_90a);
  3. holds each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the main path gives it, TF32 off, and times
     both with CUDA events;
  4. runs ``LatentDynamics.predict`` of ``ns2d_config()`` at full width
     (batch 32, 29 steps, 116-frame decode chunks, bf16 activations, f32
     weights from a seeded generator), checks the output and that every
     kernel launched as often as the model's layer specs imply, compares
     the kernel path with the all-plain path in f32 on a small input, and
     times frames/s of both paths;
  5. prints one JSON line of per-kernel results, then the closing JSON line.

Any failed check or exception exits non-zero before the closing line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

BATCH, STEPS, CHUNK = 32, 29, 116
REPS = 3  # timed predicts per path and round (two rounds per path)
_FAILS: list = []


def _check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        _FAILS.append(what)


def cuda_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Mean time of fn() in ms by CUDA events around `reps` calls, after one
    warm-up call unless `warm` is False."""
    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, rel_tol, reps=5):
    """Run both versions on the same inputs; error relative to max|plain|."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(out).all())
    _check(finite and out.shape == ref.shape and err <= rel_tol * scale,
           f"{name}: max_abs_err {err:.3e} <= {rel_tol:.0e} x max|plain| "
           f"({rel_tol * scale:.3e})")
    ms, plain_ms = cuda_ms(kernel_fn, reps), cuda_ms(plain_fn, reps)
    print(f"      {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return err, ms, plain_ms


# -- phase 3: each kernel against its plain version --------------------------

def check_rollout(dev, gen):
    from lns_tpu_torch.kernels.prop_rollout import (fused_rollout, fused_rollout_plain,
                                                    pack_simple_cnn)
    from lns_tpu_torch.models.propagator import SimpleCNN
    from lns_tpu_torch.ops.initializers import init_weights_

    results = {}
    # (tag, dtype, batch, H, W, C_lat, C, steps, padding, rel_tol)
    cases = [
        # f32 over all steps: summation order only, grown over the steps
        (f"f32 {STEPS} steps circular B{BATCH} 8x8 C128", torch.float32, BATCH, 8, 8, 16, 128,
         STEPS, "circular", 1e-4),
        # bf16, one step: both versions round at the same points; an f32 sum
        # in another order can move a value across a bf16 rounding boundary
        (f"bf16 1 step circular B{BATCH} 8x8 C128", torch.bfloat16, BATCH, 8, 8, 16, 128, 1,
         "circular", 2e-2),
        ("f32 4 steps zeros B2 7x15 C64", torch.float32, 2, 7, 15, 64, 64, 4, "zeros", 2e-5),
        ("f32 4 steps half_periodic_x B2 6x12 C64", torch.float32, 2, 6, 12, 64, 64, 4,
         "half_periodic_x", 2e-5),
        ("f32 4 steps half_periodic_y B2 12x6 C64", torch.float32, 2, 12, 6, 64, 64, 4,
         "half_periodic_y", 2e-5),
    ]
    for tag, dt, b, h, w, c_lat, c, steps, pm, tol in cases:
        cnn = init_weights_(SimpleCNN(c_lat, 3, c, 2, padding_mode="circular"), gen)
        packed = pack_simple_cnn(cnn.to(dev), dt)
        z0 = torch.randn(b, h, w, c_lat, generator=gen).to(dev)
        results[tag] = compare(
            f"prop_rollout {tag}",
            lambda: fused_rollout(z0, packed, steps, 3, 2, pm),
            lambda: fused_rollout_plain(z0, packed, steps, 3, 2, pm), tol, reps=3)
    # the main path's call: bf16, all steps, B = 32
    cnn = init_weights_(SimpleCNN(16, 3, 128, 2), gen).to(dev)
    packed = pack_simple_cnn(cnn, torch.bfloat16)
    z0 = torch.randn(BATCH, 8, 8, 16, generator=gen).to(dev)
    ms = cuda_ms(lambda: fused_rollout(z0, packed, STEPS, 3, 2, "circular"), 3)
    plain_ms = cuda_ms(lambda: fused_rollout_plain(z0, packed, STEPS, 3, 2, "circular"), 3)
    print(f"      prop_rollout bf16 {STEPS} steps B{BATCH} (main path): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    err = max(r[0] for r in results.values())
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_fab_core(dev, gen, calls_per_predict):
    """calls_per_predict: {field side: FAB core calls per predict}."""
    from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core

    n, c, d = 8, 64, 64
    errs, ms_sum, plain_sum = [], 0.0, 0.0
    # the main path's square fields, then both orientations of a non-square
    # one (the plain version branches on w > h; the kernel must not care),
    # and odd sides (a last row tile that is only partly filled)
    shapes = [(CHUNK, hw, hw) for hw in sorted(calls_per_predict)] + [
        (4, 12, 24), (4, 24, 12), (2, 15, 31)]
    for b, h, w in shapes:
        u = torch.randn(b, h, w, c, generator=gen)
        kx = torch.randn(b, n, h, h, generator=gen) / h
        ky = torch.randn(b, n, w, w, generator=gen) / w
        w_in = torch.randn(c, n, d, generator=gen) / c ** 0.5
        w_o1 = torch.randn(n, d, c, generator=gen) / d ** 0.5
        args = [t.to(dev) for t in (u, kx, ky, w_in, w_o1)]
        # f32: sums over h*w*c terms in another order; bf16: the plain
        # version rounds a, bb and m to bf16, the kernel keeps them in f32
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            a = [args[0].to(dt), args[1].to(dt), args[2].to(dt), args[3], args[4]]
            err, ms, plain_ms = compare(
                f"fab_core {str(dt)[6:]} b{b} {h}x{w} c{c} n{n}",
                lambda: fab_fused_core(*a), lambda: fab_core_plain(*a), tol)
            errs.append(err)
            if dt == torch.bfloat16 and h == w:
                ms_sum += ms * calls_per_predict[h]
                plain_sum += plain_ms * calls_per_predict[h]
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum}


def check_group_norm(dev, gen, sites):
    """sites: {(batch, spatial, C, groups, eps, swish): calls per predict}."""
    from lns_tpu_torch.kernels.group_norm import (fused_group_norm_swish,
                                                  group_norm_swish_plain)

    errs, ms_sum, plain_sum = [], 0.0, 0.0
    for (b, spatial, c, g, eps, swish), calls in sorted(sites.items()):
        x = (torch.randn((b,) + spatial + (c,), generator=gen) * 2 + 0.5).to(dev)
        scale = (torch.randn(c, generator=gen) * 0.1 + 1).to(dev)
        bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
        # f32: statistics summed in another order; bf16: both round once
        # from f32, so at most about one bf16 ulp apart
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            xd = x.to(dt)
            err, ms, plain_ms = compare(
                f"group_norm {str(dt)[6:]} {b}x{'x'.join(map(str, spatial))}x{c} G{g} "
                f"eps{eps:g}{' +swish' if swish else ''}",
                lambda: fused_group_norm_swish(xd, scale, bias, g, eps, swish),
                lambda: group_norm_swish_plain(xd, scale, bias, g, eps, swish), tol)
            errs.append(err)
            if dt == torch.bfloat16:
                ms_sum += ms * calls
                plain_sum += plain_ms * calls
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum}


# -- the model's kernel call sites and expected launch counts ---------------

def call_sites(model, dev):
    """Every GroupNorm and FAB-block call of one encode (batch BATCH) and one
    decode (batch CHUNK), found with forward hooks on a one-frame run of the
    plain path. Returns ({(batch, spatial, C, groups, eps, swish): calls per
    predict}, {FAB field side: calls per predict})."""
    from lns_tpu_torch.ops.factorized_attention import FABlock2D
    from lns_tpu_torch.ops.norms import GroupNorm

    n_chunks = -(-BATCH * STEPS // CHUNK)
    seen, hooks = [], []
    for name, m in model.named_modules():
        if not name.startswith("vq_ae.") or not isinstance(m, (GroupNorm, FABlock2D)):
            continue
        part = name.split(".")[1]

        def hook(mod, args, kwargs, out, part=part):
            spatial = tuple(args[0].shape[2:])
            if isinstance(mod, FABlock2D):
                seen.append((part, "fab", spatial))
            else:
                seen.append((part, "gn", (spatial, mod.weight.numel(), mod.num_groups,
                                          mod.eps, bool(kwargs.get("apply_swish", False)))))
        hooks.append(m.register_forward_hook(hook, with_kwargs=True))
    cfg = model.cfg
    model.use_kernels(False)
    with torch.no_grad():
        model.decode(model.encode(torch.zeros(1, cfg.Ly, cfg.Lx, cfg.in_channels, device=dev)))
    model.use_kernels(True)
    for h in hooks:
        h.remove()
    gn, fab = {}, {}
    for part, what, key in seen:
        batch, calls = (BATCH, 1) if part == "encoder" else (CHUNK, n_chunks)
        if what == "fab":
            fab[key[0]] = fab.get(key[0], 0) + calls
        else:
            gn[(batch,) + key] = gn.get((batch,) + key, 0) + calls
    return gn, fab


def expected_launches(cfg):
    """Launches per predict that the layer specs imply: the rollout once,
    the FAB core once per FAB block per decode chunk, the GroupNorm kernel
    once per GN site (two per ResidualBlock, one per GN layer and per FAB
    ``in_norm``) per encode or decode chunk."""
    from lns_tpu_torch.models.specs import decoder_spec, encoder_spec

    def gns(specs):
        return sum({"resblock": 2, "gn": 1, "fablock": 1}.get(s.kind, 0) for s in specs)

    n_chunks = -(-BATCH * STEPS // CHUNK)
    n_fab = sum(s.kind == "fablock" for s in decoder_spec(cfg))
    return {"prop_rollout": 1, "fab_core": n_fab * n_chunks,
            "group_norm": gns(encoder_spec(cfg)) + n_chunks * gns(decoder_spec(cfg))}


# -- main -------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lns_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    msgs = _build.build(ptxas_verbose="-v" in sys.argv)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {_build.library_path().name})")
    if msgs:
        print(msgs.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels = run(dev)
    print(json.dumps({"kernels": kernels}))
    if _FAILS:
        print(f"chip_smoke: {len(_FAILS)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def run(dev):
    """Phases 3 and 4 on `dev`; returns the per-kernel results."""
    from lns_tpu_torch.config import ns2d_config
    from lns_tpu_torch.kernels import fab_core, group_norm, prop_rollout
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.ops.initializers import init_weights_

    cfg = ns2d_config()
    gen = torch.Generator().manual_seed(0)
    model = init_weights_(LatentDynamics(cfg, dtype=torch.bfloat16, ae_dtype=torch.bfloat16),
                          gen).to(dev)
    sites, fab_sites = call_sites(model, dev)
    expect = expected_launches(cfg)
    _check(sum(sites.values()) == expect["group_norm"],
           f"GroupNorm calls found {sum(sites.values())} == spec count {expect['group_norm']}")
    _check(sum(fab_sites.values()) == expect["fab_core"] and sorted(fab_sites) == [16, 32],
           f"FAB calls found {fab_sites} == spec count {expect['fab_core']}")

    print("-- kernels against their plain versions (TF32 off)", flush=True)
    t0 = time.perf_counter()
    res_roll = check_rollout(dev, gen)
    res_fab = check_fab_core(dev, gen, fab_sites)
    res_gn = check_group_norm(dev, gen, sites)
    print(f"      comparisons took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"-- main path: NS2d predict, batch {BATCH}, {STEPS} steps, decode chunk {CHUNK}, "
          "bf16", flush=True)
    x = torch.randn(BATCH, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen).to(dev)
    counted = {"prop_rollout": prop_rollout.fused_rollout, "fab_core": fab_core.fab_fused_core,
               "group_norm": group_norm.fused_group_norm_swish}
    for f in counted.values():
        f.launches = 0
    y = model.predict(x, STEPS, decode_chunk=CHUNK)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counted.items()}
    _check(tuple(y.shape) == (BATCH, STEPS, cfg.Ly, cfg.Lx, cfg.in_channels),
           f"output shape {tuple(y.shape)}")
    _check(bool(torch.isfinite(y).all()), "output finite")
    for k, n in launches.items():
        _check(n == expect[k] and n > 0, f"{k} launches {n} == {expect[k]}")

    # the kernel path against the all-plain path, f32, small input; the
    # JAX package holds its own predict to 3e-4 (tests/test_torch_export.py)
    m32 = LatentDynamics(cfg).to(dev)
    m32.load_state_dict(model.state_dict())
    xs = x[:2].float()
    yk = m32.use_kernels(True).predict(xs, 4, decode_chunk=CHUNK)
    yp = m32.use_kernels(False).predict(xs, 4, decode_chunk=CHUNK)
    err = (yk - yp).abs().max().item()
    _check(bool(torch.isfinite(yk).all()) and err <= 3e-4,
           f"f32 predict B2 4 steps, kernels vs plain: max_abs_err {err:.3e} <= 3e-4")
    del m32, yk, yp

    # frames/s: each predict timed alone by CUDA events (it ends on the host
    # with a synchronize), paths alternated plain, kernel, kernel, plain
    frames = BATCH * STEPS
    times = {True: [], False: []}
    for flag in (False, True):
        model.use_kernels(flag)
        model.predict(x, STEPS, decode_chunk=CHUNK)  # warm-up
    for flag in (False, True, True, False):
        model.use_kernels(flag)
        for _ in range(REPS):
            times[flag].append(cuda_ms(lambda: model.predict(x, STEPS, decode_chunk=CHUNK),
                                       1, warm=False))
    model.use_kernels(True)
    for flag, label in ((True, "kernel path"), (False, "plain path")):
        t = sorted(times[flag])
        med = t[len(t) // 2]
        print(f"      predict {label}: median {med:.2f} ms (min {t[0]:.2f}, max {t[-1]:.2f}, "
              f"n={len(t)}), {frames / med * 1e3:.1f} frames/s", flush=True)

    kernels = [
        {"name": "prop_rollout", "route": "cuda", "source": "lns_tpu_torch/csrc/prop_rollout.cu",
         "replaces": "lns_tpu/pallas_kernels/prop_rollout.py:292", **res_roll},
        {"name": "fab_core", "route": "cuda", "source": "lns_tpu_torch/csrc/fab_core.cu",
         "replaces": "lns_tpu/pallas_kernels/fab_core.py:170", **res_fab},
        {"name": "group_norm", "route": "triton", "source": "lns_tpu_torch/kernels/group_norm.py",
         "replaces": "lns_tpu/pallas_kernels/group_norm.py:50", **res_gn},
    ]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
