"""What the card probes (``probe_bw``, ``probe_fab_mega``, ``probe_layouts``,
``probe_fab_core``) share: the card and its kernel library, two clocks, a
check of a kernel against its plain version, device time by the profiler,
and a library built from an edited copy of the sources."""

from __future__ import annotations

import shutil
import subprocess
import sys

import torch

from lns_tpu_torch.kernels import _build

# the H100 SXM's published peaks (dense): bf16 tensor cores, f32 on CUDA
# cores, HBM3 bytes. Shares are stated against these; a measured copy rate
# stands beside them, it does not replace them.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def card(name: str):
    """The first CUDA device, with the kernel library built, and the card's
    name and power limit as nvidia-smi gives them; exits with code 1 where
    there is no CUDA device."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; this probe runs only on the card", file=sys.stderr)
        raise SystemExit(1)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}", flush=True)
    return torch.device("cuda", 0), smi


def events_ms(fn, reps: int = 10) -> float:
    """Mean time of fn() in ms by CUDA events around `reps` back-to-back
    calls, after one warm-up call (the host's launch pace included)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one fn() in ms with the host's launch cost taken out:
    `calls` calls in one CUDA graph, replayed `reps` times between CUDA
    events (after one warm-up call and one replay)."""
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
    ms = start.elapsed_time(end) / (reps * calls)
    del g
    return ms


def held(name: str, out, ref, rel_tol: float = 0.0, max_differ: float = 1.0,
         atol: float | None = None) -> bool:
    """Print PASS or FAIL for `out` against `ref` (the same shape, finite):
    with `atol`, every element within atol + rel_tol |ref| (numpy's
    assert_allclose); else the largest error within rel_tol x max|ref| and at
    most `max_differ` of the elements not equal (rel_tol 0: bitwise)."""
    same = tuple(out.shape) == tuple(ref.shape)
    o, r = out.float(), ref.float()
    finite = bool(torch.isfinite(o).all()) if same else False
    err = (o - r).abs().max().item() if same else float("inf")
    differ = (out != ref).float().mean().item() if same else 1.0
    scale = r.abs().max().item()
    if atol is not None:
        ok = same and finite and bool(((o - r).abs() <= atol + rel_tol * r.abs()).all())
        bound = f"atol {atol:g} + rtol {rel_tol:g} |plain|"
    else:
        ok = same and finite and err <= rel_tol * scale and differ <= max_differ
        bound = (f"{rel_tol:g} x max|plain| ({rel_tol * scale:.3e})" if rel_tol else "bitwise")
    print(f"{'PASS' if ok else 'FAIL'} {name}: max_abs_err {err:.3e} ({bound}); "
          f"{differ:.2%} of elements differ"
          + (f" (<= {max_differ:.0%})" if max_differ < 1 else ""), flush=True)
    return ok


def kernel_ms(fn, keys, flush: bool = False, calls: int = 5) -> dict:
    """Device ms per call of fn() of the kernels whose names contain each of
    `keys` (summed over their launches), by ``torch.profiler`` over `calls`
    calls after a warm-up one; with `flush`, each call follows a write of
    128 MiB, which leaves none of its inputs in the 50 MB L2 (the write's
    own kernel is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush:
                buf.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(keys, 0.0)
    for e in prof.key_averages():
        for key in keys:
            if key in e.key:
                out[key] += e.device_time_total / (1e3 * calls)
    return out


_SOURCE, _BUILD = _build.SOURCE_DIR, _build.BUILD_DIR  # the checkout's own


def edited(src: str, edits, what: str) -> str:
    """`src` with each (anchor, replacement) pair of `edits` applied in turn
    to the first match of its anchor; raises if an anchor is not found."""
    for anchor, new in edits:
        if anchor not in src:
            raise RuntimeError(f"{what}: anchor not found: {anchor!r}")
        src = src.replace(anchor, new, 1)
    return src


def use_copy(tag: str, source: str, edits, extra: str = "", ptxas_verbose: bool = False) -> str:
    """Build a copy of ``csrc/`` with `edits` applied to `source` (a file name
    in ``csrc/``; ``edited``) and `extra` appended to it, into
    ``lns_tpu_torch/_build/probe/<tag>/`` (git-ignored), and make it the
    library the wrappers load (``_build.library()``); returns nvcc's
    messages (with `ptxas_verbose`, registers and spills)."""
    root = _BUILD / "probe" / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_SOURCE, root / "csrc")
    src = edited((root / "csrc" / source).read_text(), edits, f"use_copy {tag}: {source}")
    (root / "csrc" / source).write_text(src + extra)
    _build.SOURCE_DIR, _build.BUILD_DIR, _build._lib = root / "csrc", root / "build", None
    msgs = _build.build(ptxas_verbose=ptxas_verbose)
    _build.library()
    return msgs
