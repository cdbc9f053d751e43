#!/usr/bin/env python3
"""The readings that set a cell's limits (``limits/<cell>.json``): the
program on a dozen seeds or more, and the control on three or more, each
judged as a run of ``run.py`` judges the window's outputs (``judge.py``).

    python3 portbench/control.py --workload <name> [--seeds 12] [--control-seeds 3]
                                 [--seconds 2] [--first-seed 7000000001] [--out FILE]

The control is the plain reference put in the program's place and computed
one precision below the configuration's: the configuration serves bf16, so
the control rounds every weight and every layer's output to fp8 (e4m3,
saturating) with f32 accumulation. For each seed the program runs a short
closed loop at the cell's load (``--seconds``) and the sampled predicts are
judged; the control takes the same sampled inputs, runs its own encode,
rollout and decode, and is judged the same way. One process reads every
seed, so the set-up is paid once. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def control_readings(ref_mod, cell, state, samples) -> dict:
    """The control's numbers for `samples`' inputs."""
    from judge import control_samples, readings

    ctrl = ref_mod.LNS(cell.widths, state, fp8=True)
    got = control_samples(ctrl, samples, cell.traffic["steps"], cell.traffic["to_x"], cell.widths)
    return readings(ref_mod.LNS(cell.widths, state), got, cell.widths)


def read_seeds(cell, seeds, control_seeds, seconds, device, sync, log=print):
    """Per seed the program's readings and, for the first `control_seeds`
    seeds, the control's."""
    import torch

    import harness as H
    from judge import readings

    ref_mod = H.load_reference(cell.config)
    model = probe = None
    rows = []
    for n, seed in enumerate(seeds):
        gen = H.generator(seed, device)
        state = H.make_state_dict(ref_mod, cell.widths, gen, device)
        inputs = H.make_inputs(cell, gen, device)
        if model is None:
            model = H.build_model(cell, state, device)
            probe = H.Probe(model)
            for i in range(H.WARMUP):
                model.predict(**inputs[i % len(inputs)], **H.predict_args(cell))
        else:
            model.load_state_dict(state, strict=True)
        reservoir = H.Reservoir(H.SAMPLES, seed)
        win = H.closed_loop(model, probe, inputs, cell, seconds, sync, reservoir)
        samples = reservoir.items
        row = {"seed": seed, "predicts": win.count,
               "program": readings(ref_mod.LNS(cell.widths, state), samples, cell.widths)}
        if n < control_seeds:
            row["control"] = control_readings(ref_mod, cell, state, samples)
        rows.append(row)
        log(json.dumps(row))
        del samples, reservoir
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def summary(rows) -> dict:
    """Per number the lower reading (the largest of the program's) and the
    upper one (the smallest of the control's)."""
    out = {}
    for k in rows[0]["program"]:
        lo = max(r["program"][k] for r in rows)
        ctl = [r["control"][k] for r in rows if "control" in r]
        out[k] = {"lower": lo, "upper": min(ctl) if ctl else None,
                  "program": [r["program"][k] for r in rows], "control": ctl}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=7000000001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    import harness as H

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    cell = H.load_cell(H.load_spec(ROOT), args.workload, ROOT)
    from lns_tpu_torch.kernels import _build

    _build.library()
    t0 = time.perf_counter()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = read_seeds(cell, seeds, args.control_seeds, args.seconds, torch.device("cuda", 0),
                      torch.cuda.synchronize)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "seconds": time.perf_counter() - t0, "rows": rows, "summary": summary(rows)}
    for k, v in out["summary"].items():
        print(f"{k}: lower {v['lower']:.6g} upper {v['upper']:.6g}"
              if v["upper"] is not None else f"{k}: lower {v['lower']:.6g}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
