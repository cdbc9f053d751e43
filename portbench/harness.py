"""The benchmark of ``lns_tpu_torch``: what one run of one cell does, apart
from its command line (``run.py``).

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the model's widths (``lns_tpu_torch.config.
  Config(**widths)``), the precision it is served in, its source, what was
  reduced and assumed, and the name of its plain reference under
  ``reference/``;
* ``reference/<name>.py``: the configuration's plain reference, a module
  that keeps the contract below;
* ``traffic/<traffic>.json``: batch, steps, whether the frames are decoded
  and in what chunks (``to_x``, ``decode_chunk``), how many distinct input
  batches the run cycles through (``inputs``) and ``why``; for a
  configuration whose propagator takes each sample's parameter, also
  ``"cond": {"low": a, "high": b}``: each input batch then carries ``cond``
  [batch], f32, drawn U(a, b), as the model takes it (the ``why`` says
  whether raw or normalised);
* ``metrics/<metric>.py``: a reader of one per-layer metric (``read(ctx)``,
  None where it finds nothing);
* ``limits/<cell>.json``: each number that decides ``correct``, its limit
  and the readings the limit was set from.

The contract of a reference module, which ``make_state_dict``,
``work.predict_work``, ``judge.py`` and ``control.py`` hold to:

* ``param_shapes(cfg)``: every parameter's state-dict name (the reference
  trainer's) and shape, in the order the state dict is drawn;
  ``init_kind(name, shape)``: how it is drawn, 'uniform', 'normal' or
  'norm' (``make_state_dict``);
* ``LNS(cfg, params, fp8=False, channel_fab=False)``: the model over the
  state dict `params`, on the device they are on (``meta`` included):
  ``encode`` x [B, H, W, C] -> z [B, h, w, c], ``step`` z -> z and
  ``decode`` z -> x, all NHWC and float32. ``fp8`` computes it one precision
  below the configuration's (the control); ``channel_fab`` picks the form
  whose operations ``work.py`` counts. The latent grid is whatever
  ``encode`` returns: nothing assumes it from the field's sides;
* ``LNS.p``: every parameter by its state-dict name, the very tensors the
  model computes with (``work.py`` records which of them a ``step`` reads:
  kernel 1's weights);
* ``LNS.calls``: what ``encode`` and ``decode`` ran of kernels 2 and 3, one
  entry per call: ('gn', elements, channels) per autoencoder GroupNorm,
  ('fab', b, h, w, c, heads, dim_head, dim_out) per factorized-attention
  core. ``step`` records nothing;
* for a configuration whose step takes each sample's parameter (its
  traffic has ``cond``): ``step(z, cond)``, cond [B] one per row of z, and
  ``conditioning(cond)``, what depends on the parameter alone (the
  embedding, its MLP, each block's projection and FiLM scale), which
  ``step`` computes once per call. By ``conditioning`` ``work.py`` knows
  such a reference: it counts the conditioning once per sample of a
  predict, not once per step, and its bytes once in kernel 1's.

A run builds the model as a user's inference script does (bf16 activations,
f32 parameters, kernels on), loads a state dict made on the device from the
seed under the reference trainer's key names (``strict=True``), warms up the
cell's shapes, then calls ``LatentDynamics.predict`` in a closed loop for the
window: one caller issues the next predict when the last one has returned
and ``torch.cuda.synchronize()`` has ended. The encode and decode calls inside
predict go through a probe that keeps, for a sample of the predicts drawn
from the seed, what the encoder gave and what the decoder took, and, in the
traced part of a traced run, opens a profiler range around each call (and
around each predict and its synchronize), by which the trace's reduction
(``devtrace.py``) finds the device operations each call launched.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SAMPLES = 2          # predicts per run whose outputs are compared with the reference
WARMUP = 3           # predicts at the cell's shapes before the window
TRACED_S = 3.0       # seconds at the end of a traced run's window under torch.profiler
BANNED = ("jax", "jaxlib", "flax", "lns_tpu")  # top-level module names no run may load


# -- the files ----------------------------------------------------------------

def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def widths(self) -> dict:
        return self.config["widths"]


def _reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: a metric that lists its cells, if it
    names this one; one that lists none, in every cell."""
    return cell in metric.get("workloads", [cell])


def load_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """A workload of `spec` with its configuration, traffic and limits read
    from the benchmark's folder under `root`."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w, bench = work[name], root / spec["paths"][0]
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, w["config"], load_json(root / configs[w["config"]]["file"]),
                load_json(bench / "traffic" / f"{w['traffic']}.json"),
                load_json(bench / "limits" / f"{name}.json"), e2e, per_layer)


def load_metric(name: str, bench: Path = BENCH):
    """The reader module of a per-layer metric, ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def load_reference(config: dict):
    """The module of a configuration's plain reference, ``reference/<name>.py``."""
    return importlib.import_module(f"reference.{config['reference']}")


# -- weights and inputs from the seed -----------------------------------------

def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**63)


@torch.no_grad()
def make_state_dict(reference, widths: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every parameter under the reference trainer's names, f32, made on
    `device` in two calls of `gen`: U(-1, 1) for all but the positional
    embeddings, then scaled per tensor as torch's defaults draw them (a conv
    or linear weight and its bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)); a norm
    scale 1 + U(-0.1, 0.1), its shift U(-0.1, 0.1), so the affine is not the
    identity); N(0, 0.02) for the positional embeddings."""
    shapes = reference.param_shapes(widths)
    kinds = {k: reference.init_kind(k, s) for k, s in shapes.items()}
    n_u = sum(math.prod(s) for k, s in shapes.items() if kinds[k] != "normal")
    n_n = sum(math.prod(s) for k, s in shapes.items() if kinds[k] == "normal")
    uni = torch.rand(n_u, generator=gen, device=device).mul_(2).sub_(1)
    nrm = torch.randn(max(n_n, 1), generator=gen, device=device).mul_(0.02)
    out, off = {}, {"uniform": 0, "normal": 0}
    for k, s in shapes.items():
        src, key = (nrm, "normal") if kinds[k] == "normal" else (uni, "uniform")
        t = src[off[key]:off[key] + math.prod(s)].view(s)
        off[key] += math.prod(s)
        if kinds[k] == "norm":
            t = t.mul_(0.1).add_(1.0) if k.endswith(".weight") else t.mul_(0.1)
        elif kinds[k] == "uniform":
            fan_in = math.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:])
            t = t.mul_(1.0 / math.sqrt(fan_in))
        out[k] = t
    return out


def make_inputs(cell: Cell, gen: torch.Generator, device) -> List[Dict[str, torch.Tensor]]:
    """The distinct input batches the window cycles through, each the
    per-batch arguments of ``predict``: ``x`` [batch, H, W, C], f32,
    standard normal, all made in one call; where the traffic has ``cond``,
    also ``cond`` [batch], f32, U(low, high), all made in one call after."""
    w, t = cell.widths, cell.traffic
    x = torch.randn(t["inputs"], t["batch"], w["Ly"], w["Lx"], w["in_channels"],
                    generator=gen, device=device)
    out = [{"x": xi} for xi in x.unbind(0)]
    if "cond" in t:
        lo, hi = t["cond"]["low"], t["cond"]["high"]
        c = torch.rand(t["inputs"], t["batch"], generator=gen, device=device).mul_(hi - lo).add_(lo)
        for inp, ci in zip(out, c.unbind(0)):
            inp["cond"] = ci
    return out


def build_model(cell: Cell, state: Dict[str, torch.Tensor], device):
    """``LatentDynamics`` as a user builds it for inference: the served
    dtypes, kernels on, the state dict loaded with ``strict=True``."""
    from lns_tpu_torch.config import Config
    from lns_tpu_torch.models import LatentDynamics

    dt = {"bfloat16": torch.bfloat16, "float32": None}
    model = LatentDynamics(Config(**cell.widths), dtype=dt[cell.config["dtype"]],
                           ae_dtype=dt[cell.config["ae_dtype"]], device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


# -- the probe around encode and decode -----------------------------------------

class Probe:
    """Wraps the model's ``encode`` and ``decode`` (the calls ``predict``
    makes): keeps the last encoder output and decoder input. With
    ``traced`` set, each call runs inside a profiler range of its name and
    adds its frames to ``frames``, and ``closed_loop`` opens ranges around
    each predict and its synchronize."""

    def __init__(self, model):
        self.traced = False
        self.z0 = self.zs = None
        self.frames = {"encode": 0, "decode": 0}
        enc, dec = model.encode, model.decode
        model.encode = lambda x: self._call("encode", enc, x)
        model.decode = lambda z: self._call("decode", dec, z)

    def span(self, what):
        return torch.profiler.record_function(what) if self.traced else nullcontext()

    def _call(self, what, fn, arg):
        with self.span(what):
            out = fn(arg)
        if self.traced:
            self.frames[what] += arg.shape[0]
        if what == "encode":
            self.z0 = out
        else:
            self.zs = arg
        return out


@dataclass
class Sample:
    """One predict of the window kept for the comparison."""
    index: int
    x: torch.Tensor
    z0: torch.Tensor
    zs: torch.Tensor
    y: Optional[torch.Tensor]
    cond: Optional[torch.Tensor] = None


class Reservoir:
    """A uniform sample of `k` of the window's predicts, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, make):
        if i < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = make()


@dataclass
class Window:
    """What a closed loop of predicts measured."""
    latencies_s: List[float] = field(default_factory=list)
    enqueue_s: List[float] = field(default_factory=list)
    frames: int = 0
    wall_s: float = 0.0

    @property
    def count(self) -> int:
        return len(self.latencies_s)


def predict_args(cell: Cell) -> dict:
    """The arguments of ``predict`` besides an input's own (``make_inputs``)."""
    t = cell.traffic
    return {"steps": t["steps"], "to_x": t["to_x"], "decode_chunk": t["decode_chunk"]}


def closed_loop(model, probe: Probe, inputs, cell: Cell, seconds: float, sync,
                reservoir: Optional[Reservoir] = None, first: int = 0) -> Window:
    """Predicts back to back until `seconds` have passed: each timed on the
    host clock from the call to the end of `sync()`, its enqueue from the
    call to its return. Every predict starts before the deadline (or is
    one of the first ``SAMPLES``); the window ends when the last one has."""
    args, win = predict_args(cell), Window()
    t_start = time.perf_counter()
    deadline, i = t_start + seconds, first
    while True:
        inp = inputs[i % len(inputs)]
        t0 = time.perf_counter()
        with probe.span("predict"):
            y = model.predict(**inp, **args)
        t1 = time.perf_counter()
        with probe.span("sync"):
            sync()
        t2 = time.perf_counter()
        win.latencies_s.append(t2 - t0)
        win.enqueue_s.append(t1 - t0)
        win.frames += y.shape[0] * y.shape[1]
        if reservoir is not None:
            reservoir.offer(i, lambda: Sample(i, inp["x"], probe.z0,
                                              probe.zs if args["to_x"] else y,
                                              y if args["to_x"] else None, inp.get("cond")))
        i += 1
        if t2 >= deadline and win.count >= SAMPLES:
            win.wall_s = t2 - t_start
            return win


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def loaded_banned() -> List[str]:
    """Modules whose top-level name is one no run may load."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
