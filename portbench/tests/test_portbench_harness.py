"""The benchmark's files against its contract, its import rules, the lookup
of configurations, traffic mixes, metrics and limits by name, and the
refusal to run without a card."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import harness as H

ROOT, BENCH = H.ROOT, H.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_the_contract():
    spec = H.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"] == ["python3", "portbench/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json" and (ROOT / c["file"]).exists()
        assert c["reduced"] == H.load_json(ROOT / c["file"])["reduced"]
    configs = {c["name"] for c in spec["configs"]}
    assert configs == {w["config"] for w in spec["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one in every cell
        c = H.load_cell(spec, cell)
        assert len(c.end_to_end) >= 2 and c.per_layer
    assert len(json.dumps(spec)) < 64 * 1024


def test_metric_files_agree_with_benchmark_json():
    """A metric file states its layer, source and end-to-end metric as
    BENCHMARK.json does, and the cells it was written for. The cells that
    report it are BENCHMARK.json's list, to which a later configuration
    adds its own without editing the file."""
    for m in H.load_spec()["per_layer"]:
        mod = H.load_metric(m["name"])
        assert (mod.LAYER, mod.SOURCE, mod.MOVES) == (m["layer"], m["source"], m["moves"])
        assert set(mod.WORKLOADS) <= set(m["workloads"])
        assert callable(mod.read)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``lns_tpu_torch`` is not ``lns_tpu``."""
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(H.BANNED), path
        if path.parent.name == "reference":
            assert "lns_tpu_torch" not in tops, path


def test_loaded_banned_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lns_tpu_torch_fake", object())
    assert H.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "lns_tpu.models", object())
    assert H.loaded_banned() == ["lns_tpu"]


def test_files_are_found_by_name(tmp_path):
    """A configuration, traffic mix, metric and cell added as files, with
    entries in BENCHMARK.json, run through the same code unedited."""
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = H.load_spec()
    b = tmp_path / "portbench"
    cfg = H.load_json(b / "configs" / "ns2d.json")
    cfg["widths"]["prop_n_block"] = 2
    cfg["reduced"] = ["prop_n_block"]
    (b / "configs" / "ns2d_two.json").write_text(json.dumps(cfg))
    (b / "traffic" / "rollout.b4.s5.json").write_text(json.dumps(
        {"batch": 4, "steps": 5, "to_x": True, "decode_chunk": None, "inputs": 2}))
    (b / "limits" / "ns2d_two.rollout.b4.json").write_text(json.dumps(
        {"numbers": {"step": {"limit": 0.045}}}))
    (b / "metrics" / "frames.count.py").write_text(
        "LAYER = 'rollout driver'\nSOURCE = 'host_clock'\nMOVES = 'frames_per_s'\n"
        "WORKLOADS = ('ns2d_two.rollout.b4',)\nPATTERNS = ()\n\n"
        "def read(ctx):\n    return float(ctx.spans.frames)\n")
    spec["configs"].append({"name": "ns2d_two", "source": "x", "file": "portbench/configs/ns2d_two.json",
                            "reduced": ["prop_n_block"], "why": "x"})
    spec["workloads"].append({"name": "ns2d_two.rollout.b4", "config": "ns2d_two",
                              "traffic": "rollout.b4.s5", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "rollout driver",
                              "moves": "frames_per_s", "workloads": ["ns2d_two.rollout.b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = H.load_cell(H.load_spec(tmp_path), "ns2d_two.rollout.b4", tmp_path)
    assert cell.widths["prop_n_block"] == 2 and cell.traffic["batch"] == 4
    assert "frames.count" in [m["name"] for m in cell.per_layer]
    assert H.load_metric("frames.count", b).read(type("C", (), {"spans": H.Window(frames=7)})) == 7
    assert H.load_cell(H.load_spec(tmp_path), "ns2d.rollout.b32", tmp_path).per_layer[0][
        "name"] != "frames.count"


def test_state_dict_and_inputs_come_from_the_seed():
    cell = H.load_cell(H.load_spec(), "ns2d.rollout.b32")
    from reference import lns

    a = H.make_state_dict(lns, cell.widths, H.generator(2**31 + 11, "cpu"), "cpu")
    b = H.make_state_dict(lns, cell.widths, H.generator(2**31 + 11, "cpu"), "cpu")
    c = H.make_state_dict(lns, cell.widths, H.generator(2**31 + 12, "cpu"), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["propagator.in_proj.weight"],
                                                                       c["propagator.in_proj.weight"])
    w = a["vq_ae.decoder.model.13.weight"]  # the last up-conv, fan_in 64 * 9
    assert w.abs().max() <= 1 / 24 and w.abs().max() > 0.9 / 24
    gn = a["propagator.net.0.conv.0.weight"]
    assert (gn - 1).abs().max() <= 0.1 and a["vq_ae.decoder.model.2.pe"].std() < 0.03
    x, y = (torch.stack([i["x"] for i in H.make_inputs(cell, H.generator(2**31 + 11, "cpu"), "cpu")])
            for _ in "xy")
    assert torch.equal(x, y) and x.shape == (4, 32, 64, 64, 1)


def test_reservoir_draws_from_the_seed():
    def draw(seed):
        r = H.Reservoir(2, seed)
        for i in range(100):
            r.offer(i, lambda: i)
        return sorted(r.items)
    assert draw(5) == draw(5) and len(set(map(tuple, (draw(s) for s in range(20))))) > 10


def test_span_seconds_counts_ops_launched_inside_a_range():
    """A device op counts for the range its launch (the runtime call of the
    same correlation id) lies in, however late the op itself runs."""
    from devtrace import _span_seconds

    host = [(0, 100, "encode"), (200, 300, "encode"), (120, 180, "decode")]
    launched = {1: 10, 2: 250, 3: 150, 4: 600}
    dev = [(1000, 1500, "k", 1), (2000, 2100, "k", 2), (120, 160, "k", 3), (700, 900, "k", 4),
           (50, 60, "k", 99)]
    assert _span_seconds(dev, host, launched) == {"encode": 600 / 1e9, "decode": 40 / 1e9}
    assert _span_seconds(dev, [], launched) == {}


def test_traced_run_reads_the_host_metrics_on_the_cpu():
    """The traced path end to end at a test's size: the untraced part and
    the profiled part both run, the frames under the ranges are counted,
    and metrics with nothing to read (no device) are left out."""
    import run

    cell = H.load_cell(H.load_spec(), "ns2d.rollout.b32")
    cell.traffic.update(batch=1, steps=2, inputs=2)
    r = run.run_cell(cell, 2**31 + 9, 0.4, True, torch.device("cpu"), 0.0)
    assert r["correct"] and {"driver.enqueue_ms", "mfu_pct"} <= set(r["metrics"])
    assert "device.idle_pct" not in r["metrics"] and "encoder.us_per_frame" not in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"} and r["device"]["window_s"] > 0


def test_percentile_is_nearest_rank():
    assert H.percentile(list(range(1, 101)), 95) == 95
    assert H.percentile([3.0], 95) == 3.0


def test_run_refuses_without_a_card():
    """No CUDA card: exit 2, nothing on standard output; never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "ns2d.rollout.b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == "" and "CUDA card" in out.stderr
