#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``lns_tpu_torch``, the PyTorch and
CUDA port of the LNS latent surrogate, on one CUDA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``lns_tpu_torch``. It builds the cell from the seed (weights and input
fields made on the card), warms up the cell's shapes (the first run in a
checkout also compiles the kernel library into ``lns_tpu_torch/_build/``),
then calls ``LatentDynamics.predict`` back to back for `--seconds`, and
prints one JSON line: with ``--trace 0`` the end-to-end metrics
(``frames_per_s``, ``predict_p95_ms``, ``setup_s``), with ``--trace 1`` the
cell's per-layer metrics, read from the host clock over the first part of
the window and from a ``torch.profiler`` trace of its last seconds. After the
window it frees the model and compares a sample of the window's outputs
with the plain reference (``judge.py``); each number compared is printed
beside its limit, last on standard error and last in the JSON line.

It exits 2 and prints no result without a CUDA card or without the
program beside it, and 3 if a module of
JAX or of the JAX package was loaded. Caches go to ``.bench_cache/`` in the
checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}


@dataclass
class Context:
    """What a per-layer metric's reader (``metrics/<name>.py``) reads: the
    cell, the work of one predict (``work.predict_work``, counted with the
    cell's own reference module), the first part of a traced run's window,
    untraced, on the host clock (``spans``), and its last part under the
    profiler (``traced``, its reduced ``trace``, and the frames the traced
    predicts passed to ``encode`` and ``decode``)."""
    cell: object
    work: dict
    spans: object
    traced: object
    trace: object
    frames: dict


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of `cell` on `device`: set-up, the window, the comparison.
    Returns the result's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` and, traced, ``breakdown``, then ``checked``)."""
    import torch

    import harness as H
    from judge import check, passed, readings
    from work import predict_work

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        from lns_tpu_torch.kernels import _build

        _build.library()  # nvcc on the checkout's first run, a load after
    ref_mod = H.load_reference(cell.config)
    gen = H.generator(seed, device)
    state = H.make_state_dict(ref_mod, cell.widths, gen, device)
    inputs = H.make_inputs(cell, gen, device)
    model = H.build_model(cell, state, device)
    probe = H.Probe(model)
    for i in range(H.WARMUP):
        model.predict(**inputs[i % len(inputs)], **H.predict_args(cell))
    sync()
    setup_s = time.perf_counter() - t0
    smi = power_limit() if cuda else "no card"

    reservoir = H.Reservoir(H.SAMPLES, seed)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": {}}
    if not trace:
        win = H.closed_loop(model, probe, inputs, cell, seconds, sync, reservoir)
        result["attempted"] = win.count
        values = {"frames_per_s": win.frames / win.wall_s,
                  "predict_p95_ms": H.percentile(win.latencies_s, 95) * 1e3, "setup_s": setup_s}
        fifth = max(1, win.count // 5)
        print(f"window {win.wall_s:.3f} s, {win.count} predicts, {win.frames} frames; latency "
              f"median {statistics.median(win.latencies_s) * 1e3:.3f} ms (first fifth "
              f"{statistics.median(win.latencies_s[:fifth]) * 1e3:.3f}, last fifth "
              f"{statistics.median(win.latencies_s[-fifth:]) * 1e3:.3f}), enqueue median "
              f"{statistics.median(win.enqueue_s) * 1e3:.3f} ms", file=sys.stderr)
    else:
        from torch.profiler import ProfilerActivity, profile

        from devtrace import reduce

        traced_s = min(H.TRACED_S, seconds / 2)
        spans = H.closed_loop(model, probe, inputs, cell, seconds - traced_s, sync, reservoir)
        activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
        probe.traced = True
        with profile(activities=activities) as prof:
            traced = H.closed_loop(model, probe, inputs, cell, traced_s, sync, reservoir,
                                   first=spans.count)
        t_red = time.perf_counter()
        tr = reduce(prof)
        del prof
        t = cell.traffic
        ctx = Context(cell, predict_work(ref_mod, cell.widths, t["batch"], t["steps"], t["to_x"]),
                      spans, traced, tr, dict(probe.frames))
        result["attempted"] = spans.count + traced.count
        values = {}
        for m in cell.per_layer:
            v = H.load_metric(m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
        result["device"].update(busy_s=tr.busy_s, window_s=traced.wall_s)
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        bounds = ", ".join(f"{k} {b.s * 1e3:.4f} ms ({b.bound_by})"
                           for k, b in ctx.work["bounds"].items() if b.s)
        launched = ", ".join(f"{k} {v:.6f} s ({ctx.frames[k]} frames)" for k, v in tr.span_s.items())
        print(f"traced {traced.wall_s:.3f} s ({traced.count} predicts), busy {tr.busy_s:.3f} s; "
              f"device time launched in {launched}; untraced {spans.wall_s:.3f} s "
              f"({spans.count} predicts); "
              f"the trace read in {time.perf_counter() - t_red:.1f} s; per predict: model FLOPs "
              f"{ctx.work['flops']:.6g}, bounds {bounds}", file=sys.stderr)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1,
                        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
                        **result["device"], "nvidia_smi": smi}

    # the program's state freed, then the reference on a sample of the window's outputs
    samples = reservoir.items
    del model, probe, reservoir
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    got = readings(ref_mod.LNS(cell.widths, state), samples, cell.widths)
    checked = check(got, cell.limits["numbers"])
    result["correct"] = passed(checked) and len(samples) == H.SAMPLES
    print(f"reference on {len(samples)} predicts of the window: {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    result["checked"] = checked
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():  # fixed paths inside the checkout
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    if not (ROOT / "lns_tpu_torch").is_dir():
        print(f"run.py: no lns_tpu_torch beside {BENCH.name}/: the program under test is "
              "missing: no result", file=sys.stderr)
        return 2
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    import harness as H

    spec = H.load_spec(ROOT)
    cell = H.load_cell(spec, args.workload, ROOT)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    banned = H.loaded_banned()
    if banned:
        print(f"run.py: modules of {', '.join(banned)} were loaded: no result", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
