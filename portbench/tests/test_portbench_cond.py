"""A configuration added as files alone, whose latent grid is not the
field's aspect ratio times its height and whose step takes each sample's
parameter: the conditional, zero-padded test double ``cond_double.py``
(61x121 -> 7x15) run through ``run.run_cell`` and ``control.read_seeds`` on
the CPU, with ``cond`` drawn from its traffic file. The existing cells, with
no ``cond`` in their traffic, call ``predict`` without one."""

import json
import shutil
import sys
import time

import pytest
import torch

import cond_double
import control
import harness as H
import run
import work
from lns_tpu_torch.models import LatentDynamics

CELL = "tp_cond.rollout.b2"
SEED = 2**31 + 4242
STEPS, BATCH, LATENT = 3, 2, 16
TRAFFIC = {"batch": BATCH, "steps": STEPS, "to_x": True, "decode_chunk": None, "inputs": 2,
           "cond": {"low": 0.0, "high": 1.0},
           "why": "2 tanks x 3 steps, every frame decoded; cond: the driving frequency, normalised"}
# the program runs the double's own modules in f32: its readings are rounding
LIMITS = {"numbers": {k: {"limit": 1e-4} for k in ("encoder", "step", "decoder")}}
METRICS = ("driver.enqueue_ms", "mfu_pct", "prop_rollout_roofline")


def _cell(tmp_path, monkeypatch):
    """The double's cell, added as files to a copy of the benchmark."""
    monkeypatch.setitem(sys.modules, "reference.cond_double", cond_double)
    b = tmp_path / "portbench"
    shutil.copytree(H.BENCH, b, ignore=shutil.ignore_patterns("__pycache__"))
    (b / "configs" / "tp_cond.json").write_text(json.dumps(
        {"reference": "cond_double", "dtype": "float32", "ae_dtype": "float32", "reduced": [],
         "widths": cond_double.WIDTHS}))
    (b / "traffic" / "rollout.b2.s3.json").write_text(json.dumps(TRAFFIC))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec = H.load_spec()
    spec["configs"].append({"name": "tp_cond", "source": "x", "file": "portbench/configs/tp_cond.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": CELL, "config": "tp_cond", "traffic": "rollout.b2.s3",
                              "chips": 1, "why": "x"})
    for m in spec["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return H.load_cell(H.load_spec(tmp_path), CELL, tmp_path)


def _conds(cell):
    """The parameters of the run's input batches, drawn as the run draws them."""
    gen = H.generator(SEED, "cpu")
    H.make_state_dict(cond_double, cell.widths, gen, "cpu")
    return [i["cond"] for i in H.make_inputs(cell, gen, "cpu")]


def _record_predict(monkeypatch, change=None):
    """Every predict's keyword arguments; `change` maps the cond the
    program is handed."""
    seen, orig = [], LatentDynamics.predict

    def predict(self, *args, **kwargs):
        seen.append(dict(kwargs))
        if change is not None:
            kwargs["cond"] = change(kwargs["cond"])
        return orig(self, *args, **kwargs)
    monkeypatch.setattr(LatentDynamics, "predict", predict)
    return seen


def _record_steps(monkeypatch):
    """The cond of every step the double takes on real data (the judge's)."""
    seen, orig = [], cond_double.LNS.step

    def step(self, z, cond):
        if cond.device.type != "meta":
            seen.append(cond.clone())
        return orig(self, z, cond)
    monkeypatch.setattr(cond_double.LNS, "step", step)
    return seen


@pytest.mark.parametrize("trace", [0, 1])
def test_conditional_cell_runs_from_files(tmp_path, monkeypatch, trace):
    cell = _cell(tmp_path, monkeypatch)
    conds = _conds(cell)
    assert all(c.shape == (BATCH,) and c.dtype == torch.float32 for c in conds)
    predicts, steps = _record_predict(monkeypatch), _record_steps(monkeypatch)
    counted = []
    orig_work = work.predict_work
    monkeypatch.setattr(work, "predict_work", lambda *a: counted.append(orig_work(*a)) or counted[-1])

    r = run.run_cell(cell, SEED, 0.4, bool(trace), torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checked"]
    # the input batches' cond reached every predict, the warm-ups' too
    assert len(predicts) >= H.WARMUP + H.SAMPLES
    assert all(any(torch.equal(p["cond"], c) for c in conds) for p in predicts)
    # and the judge: each sample's cond, once per step of the sample
    assert len(steps) == H.SAMPLES
    assert all(any(torch.equal(s, c.repeat_interleave(STEPS)) for c in conds) for s in steps)
    if not trace:
        assert not counted
        return
    assert {"driver.enqueue_ms", "mfu_pct"} <= set(r["metrics"])
    (got,) = counted
    shapes = cond_double.param_shapes(cell.widths)
    weights = sum(torch.Size(s).numel() * (2 if len(s) > 1 else 4)
                  for k, s in shapes.items() if k.startswith("propagator."))
    latents = (1 + STEPS) * BATCH * 7 * 15 * LATENT * 2  # the encoder's 7x15, not 7x14
    assert got["bounds"]["prop_rollout"].nbytes == latents + weights + BATCH * 4
    assert got["conditioning"] > 0 and got["step"] > 0
    assert got["bounds"]["prop_rollout"].flops == (got["step"] * BATCH * STEPS
                                                   + got["conditioning"] * BATCH)
    assert got["flops"] == (got["encode"] * BATCH + got["step"] * BATCH * STEPS
                            + got["conditioning"] * BATCH + got["decode"] * BATCH * STEPS)
    assert got["bounds"]["group_norm"].s > 0


def test_program_handed_another_cond_is_not_correct(tmp_path, monkeypatch):
    """The probe hands the program 1 - cond in place of the input's cond:
    the judge, which steps the reference on the recorded cond, sees it."""
    cell = _cell(tmp_path, monkeypatch)
    _record_predict(monkeypatch, change=lambda c: 1 - c)
    r = run.run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert not r["correct"]
    assert r["checked"]["step"]["value"] > 100 * LIMITS["numbers"]["step"]["limit"]
    assert r["checked"]["encoder"]["value"] <= LIMITS["numbers"]["encoder"]["limit"]


def test_control_takes_each_samples_cond(tmp_path, monkeypatch):
    """``control.py`` warms up, loops and runs the control with cond."""
    cell = _cell(tmp_path, monkeypatch)
    predicts, steps = _record_predict(monkeypatch), _record_steps(monkeypatch)
    rows = control.read_seeds(cell, [SEED], 1, 0.1, torch.device("cpu"), lambda: None,
                              log=lambda s: None)
    assert all(p["cond"] is not None for p in predicts)
    assert rows[0]["program"]["step"] <= LIMITS["numbers"]["step"]["limit"]
    assert rows[0]["control"]["step"] > rows[0]["program"]["step"]
    # a judged block a sample, for the program's samples and the control's; the
    # control's own rollout, a step a sample per step
    assert len(steps) == H.SAMPLES * (2 + STEPS)


@pytest.mark.parametrize("name", ["ns2d.rollout.b32", "ns2d.latents.b256", "sw.rollout.b8"])
def test_cells_without_cond_call_predict_as_before(monkeypatch, name):
    """No cond in the traffic: no draw and no cond argument, not even None."""
    cell = H.load_cell(H.load_spec(), name)
    cell.traffic.update(batch=1, steps=2, inputs=2)
    assert "cond" not in cell.traffic
    assert all(set(i) == {"x"} for i in H.make_inputs(cell, H.generator(1, "cpu"), "cpu"))
    predicts = _record_predict(monkeypatch)
    r = run.run_cell(cell, 2**31 + 3, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] and predicts
    t = cell.traffic
    assert all(p == {"x": p["x"], "steps": t["steps"], "to_x": t["to_x"],
                     "decode_chunk": t["decode_chunk"]} for p in predicts)
