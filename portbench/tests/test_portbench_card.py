"""A run of each cell on the card, short: the contract's JSON line, correct,
the device named. Skips without a CUDA card (decided inside the test)."""

import json
import subprocess
import sys

import pytest
import torch

import harness as H

CELLS = [w["name"] for w in H.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(H.BENCH / "run.py"), "--workload", name,
                          "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=1200, cwd=H.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checked" and r["metrics"]
    if trace:
        assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
