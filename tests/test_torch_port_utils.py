"""The port's debug and profiling helpers (``lns_tpu_torch.utils.debug``,
``lns_tpu_torch.utils.profiling``) against the JAX package's
(``lns_tpu.utils.debug``, ``lns_tpu.utils.profiling``) on the CPU: the same
NaN-making input raises ``FloatingPointError`` in both, ``assert_finite``
gives the JAX message for the same tree, ``Timer.report`` the JAX format;
the trace is written, and the timings are not negative.
"""

import collections
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lns_tpu.utils import debug as jdebug
from lns_tpu.utils import profiling as jprofiling
from lns_tpu_torch.utils import debug, profiling


class Log(nn.Module):
    def forward(self, x):
        return torch.log(x)


def test_nan_debugging_raises_where_jax_debug_nans_raises():
    """log of a negative value: JAX's ``jax_debug_nans`` raises
    ``FloatingPointError`` at the op; the port's hook at the first module
    whose output holds the NaN, naming it (the inner ``Log``, not the
    ``Sequential`` around it). Outside the context both return the NaN,
    and the anomaly mode is restored."""
    x = np.array([2.0, -1.0], np.float32)
    with jdebug.nan_debugging():
        with pytest.raises(FloatingPointError):
            jax.jit(jnp.log)(jnp.asarray(x)).block_until_ready()
    assert np.isnan(np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))).any()

    model = nn.Sequential(nn.Identity(), Log())
    before = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    with debug.nan_debugging():
        assert model(torch.tensor([2.0, 3.0])).isfinite().all()
        with pytest.raises(FloatingPointError, match="NaN in the output of Log"):
            model(torch.from_numpy(x))
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before
    assert torch.isnan(model(torch.from_numpy(x))).any()


@pytest.mark.filterwarnings("ignore:Error detected in SqrtBackward0")
def test_nan_debugging_checks_the_backward():
    """A forward without NaN whose backward makes one (0 x the infinite
    derivative of sqrt at 0): anomaly mode raises inside the context; the
    same backward outside it gives the NaN gradient; ``enabled=False``
    checks nothing."""
    def grad():
        x = torch.zeros(1, requires_grad=True)
        (x.sqrt() * 0).sum().backward()
        return x.grad

    with debug.nan_debugging():
        with pytest.raises(RuntimeError, match="nan"):
            grad()
    assert torch.isnan(grad()).all()
    with debug.nan_debugging(enabled=False):
        assert torch.isnan(grad()).all()
        Log()(torch.tensor([-1.0]))


def _trees(bad):
    """The same trees in numpy (for JAX) and torch (for the port), with
    `bad` in the leaves that hold one."""
    def leaf(a):
        return np.asarray(a, np.float32)

    return [
        {"b": [leaf([1.0]), (leaf([2.0]), leaf([bad, 0.0]))], "a": {"x": leaf([1.0, 2.0])}},
        [leaf([1.0]), {"k": leaf([[bad]]), "c": leaf([0.0])}],
        collections.OrderedDict([("z.weight", leaf([1.0])), ("a.bias", leaf([bad])),
                                 ("m.bias", leaf([bad]))]),
    ]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return type(tree)((k, _torch_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(tree)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_assert_finite_message_matches_jax(bad):
    """For a dict, a list and a state dict (``OrderedDict``) tree, the
    port's message equals the JAX function's, key path and all; a finite
    tree passes both, also with a module's state dict and a bf16 leaf."""
    for tree in _trees(bad):
        with pytest.raises(FloatingPointError) as ref:
            jdebug.assert_finite(tree, "params")
        with pytest.raises(FloatingPointError) as out:
            debug.assert_finite(_torch_tree(tree), "params")
        assert str(out.value) == str(ref.value)
        with pytest.raises(FloatingPointError) as out:
            debug.assert_finite(tree, "params")  # numpy leaves too
        assert str(out.value) == str(ref.value)
    for tree in _trees(0.5):
        jdebug.assert_finite(tree)
        debug.assert_finite(_torch_tree(tree))
    debug.assert_finite({"sd": nn.Linear(2, 2).state_dict(), "n": None, "s": 1.0,
                         "h": torch.ones(2, dtype=torch.bfloat16)})


def test_check_finite_in_jit_is_the_identity():
    x = torch.tensor([1.0, float("nan")])
    assert debug.check_finite_in_jit(x, "x") is x
    ref = jax.jit(lambda v: jdebug.check_finite_in_jit(v, "v"))(jnp.asarray(x.numpy()))
    assert np.array_equal(np.asarray(ref), x.numpy(), equal_nan=True)


def test_timer_report_matches_jax():
    """The same totals give the same report; a section stopped on a
    tensor (the CPU here: nothing to wait for) adds its time."""
    jt, pt = jprofiling.Timer(), profiling.Timer()
    for t in (jt, pt):
        t.totals = {"train": 1.23456, "data": 0.5, "eval": 12.0}
    assert pt.report() == jt.report() == "data: 0.500s | eval: 12.000s | train: 1.235s"
    pt.start("step")
    pt.stop("step", sync_value={"loss": torch.ones(()), "out": [torch.zeros(2)]})
    pt.start("step")
    pt.stop("step")
    assert pt.totals["step"] >= 0.0 and "step: " in pt.report()


def test_trace_writes_a_trace(tmp_path):
    """``trace`` writes a Chrome trace JSON into the directory, holding the
    block's ops."""
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_time_fn_and_host_rtt():
    """``time_fn`` calls `fn` once to warm up and then `n` times, chained
    on the carry, and returns seconds per call >= 0."""
    calls = []

    def fn(c):
        calls.append(1)
        return {"x": c["x"] * 0.5 + 1.0}

    sec = profiling.time_fn(fn, {"x": torch.ones(128)}, n=7, rtt=0.01)
    assert sec >= 0.0 and len(calls) == 8
