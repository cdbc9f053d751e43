"""The benchmark's plain reference of the conditional two-phase surrogate
(``portbench/reference/twophase_cond.py``) against the port's
``LatentDynamics`` on the CPU, on the benchmark's seeded random weights
(``harness.make_state_dict``: every gate of the FiLM path drawn, none zero):
at the widths of ``portbench/tests/cond_double.py`` (61x121x4 field, 7x15x16
latent, a 2 x 32 CondSimpleCNN) for the arithmetic, at
``twophase_conditional_config()``'s for the state dict's names and shapes,
the work counts and the cell ``twophase_cond.latents.b2048`` at a test's
batch.

Both sides compute in float32 here, in other operation orders (the port
folds the nearest 2x into a transposed conv, takes its GroupNorm statistics
in runs of rows, promotes nothing since nothing is lower): they agree to
1e-6 - 5e-6 relative over these depths, so ``TOL`` holds them to 2e-5. A
FiLM computed as ``x c`` in place of ``x (1 + c)``, or the program handed
``1 - cond``, reads 0.05 or more, far outside it.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lns_tpu_torch.config import Config, twophase_conditional_config
from lns_tpu_torch.models import LatentDynamics

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CELL = "twophase_cond.latents.b2048"
TOL = 2e-5  # f32 against f32 in other operation orders (module docstring)
COND = torch.tensor([0.3, 0.55, 0.9])  # a driving frequency per sample, Hz


@pytest.fixture(scope="module")
def bench():
    """The benchmark's folder on the import path: (harness, the reference
    module, the test double's widths)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(BENCH / "tests"))
        mp.syspath_prepend(str(BENCH))
        import cond_double
        import harness
        from reference import twophase_cond

        yield harness, twophase_cond, cond_double.WIDTHS


@pytest.fixture(scope="module")
def pair(bench):
    """The port (f32, kernels off) and the reference over one state dict,
    and an input batch of 3."""
    H, R, widths = bench
    gen = H.generator(2**31 + 28, "cpu")
    state = H.make_state_dict(R, widths, gen, "cpu")
    model = LatentDynamics(Config(**widths), device="cpu").use_kernels(False).eval()
    model.load_state_dict(state, strict=True)
    x = torch.randn(3, widths["Ly"], widths["Lx"], widths["in_channels"], generator=gen)
    return model, R.LNS(widths, state), x


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("which", ["double", "published"])
def test_param_shapes_are_the_port_state_dict(bench, which):
    """The names and shapes the benchmark draws are the port's state dict
    (``ae.*``, ``propagator.*``), so ``load_state_dict(strict=True)`` takes
    them."""
    _, R, widths = bench
    if which == "published":
        widths = twophase_conditional_config().to_dict()
    want = {k: tuple(v.shape) for k, v in
            LatentDynamics(Config(**widths), device="meta").state_dict().items()}
    assert {k: tuple(s) for k, s in R.param_shapes(widths).items()} == want


def test_encode_matches_port(pair):
    model, ref, x = pair
    with torch.no_grad():
        z = model.encode(x)
    assert z.shape == (3, 7, 15, 16)
    assert _rel(ref.encode(x), z) < TOL


def test_conditioning_matches_port(pair):
    """Each block's projection and FiLM scale, a different parameter per
    sample."""
    model, ref, _ = pair
    with torch.no_grad():
        got = model.propagator.conditioning(COND)
    want = ref.conditioning(COND)
    assert len(got) == len(want) == 2
    for (e, c), (re, rc) in zip(got, want):
        assert _rel(e, re) < TOL and _rel(c, rc) < TOL
        assert float(c.abs().min(dim=1).values.min()) > 0  # the FiLM scale is live


def test_steps_match_port_from_each_carry(pair):
    """Four steps, each of the reference from the port's carry before it,
    as the benchmark's judge takes them."""
    model, ref, x = pair
    with torch.no_grad():
        z = model.encode(x)
        shared = model.propagator.conditioning(COND)
        for _ in range(4):
            nxt = model.propagator.step(z, shared)
            assert _rel(ref.step(z, COND), nxt) < TOL
            z = nxt


def test_predict_latents_matches_reference_rollout(pair):
    """``predict_latents`` against the reference's own encode and rollout."""
    model, ref, x = pair
    with torch.no_grad():
        zs = model.predict_latents(x, 4, COND)
    z = ref.encode(x)
    for t in range(4):
        z = ref.step(z, COND)
        assert _rel(zs[:, t], z) < TOL


def test_decode_matches_port(pair):
    model, ref, x = pair
    with torch.no_grad():
        z = model.encode(x)
        y = model.decode(z)
    assert y.shape == x.shape
    assert _rel(ref.decode(z), y) < TOL


@pytest.mark.parametrize("fault", ["film_scale_as_c", "program_given_1_minus_cond"])
def test_a_wrong_conditioning_fails_the_comparison(pair, bench, monkeypatch, fault):
    """FiLM's ``1 + c`` computed as ``c`` in the reference, or the program
    handed ``1 - cond``: the step reads far outside ``TOL``."""
    model, ref, x = pair
    _, R, _ = bench
    cond = COND
    if fault == "film_scale_as_c":
        monkeypatch.setattr(R.LNS, "film", staticmethod(lambda h, c: h * c[:, :, None, None]))
    else:
        cond = 1 - COND
    with torch.no_grad():
        z = model.encode(x)
        got = model.propagator.step(z, model.propagator.conditioning(cond))
    assert _rel(ref.step(z, COND), got) > 1000 * TOL


def test_reference_imports_no_program():
    """The reference module loads neither JAX, the JAX package nor any part
    of the port (its kernels included)."""
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import reference.twophase_cond; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'lns_tpu', 'lns_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_work_counts_of_the_published_widths(bench):
    """``work.predict_work`` with this reference: the conditioning once a
    sample, the encoder's 11 GroupNorms, no decoder; 69.29 TFLOP a B2048 x
    78 predict."""
    H, R, _ = bench
    from work import predict_work

    widths = twophase_conditional_config().to_dict()
    got = predict_work(R, widths, 2048, 78, False)
    assert got["conditioning"] > 0 and got["decode"] == 0
    assert got["flops"] == (2048 * got["encode"] + 2048 * 78 * got["step"]
                            + 2048 * got["conditioning"])
    assert round(got["flops"] / 1e12, 2) == 69.29
    assert got["bounds"]["group_norm"].flops == 2048 * 8 * sum(
        n for n in _encoder_gn_elements(R, widths))


def _encoder_gn_elements(R, widths):
    ref = R.LNS(widths, {k: torch.empty(s, device="meta")
                         for k, s in R.param_shapes(widths).items()})
    ref.encode(torch.empty(1, widths["Ly"], widths["Lx"], widths["in_channels"], device="meta"))
    assert len(ref.calls) == 11
    return [c[1] for c in ref.calls]


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(bench, trace):
    """The cell at the published widths, B2 x 3 steps, bf16 as served:
    ``correct`` under its limits; traced, the conditioning span and the
    loop's count (B x steps) read."""
    from lns_tpu_torch.utils import profiling

    H, _, _ = bench
    import run

    cell = H.load_cell(H.load_spec(), CELL)
    assert cell.traffic["cond"] == {"low": 0.3, "high": 0.9}
    cell.traffic.update(batch=2, steps=3, inputs=2)
    profiling.reset()
    r = run.run_cell(cell, 2**31 + 281, 0.3, bool(trace), torch.device("cpu"), 0.0)
    assert r["correct"], r["checked"]
    if trace:
        assert r["metrics"]["propagator.loop_steps"]["value"] == 6
        assert r["metrics"]["propagator.conditioning_ms"]["value"] > 0


def test_control_fails_every_limit(bench):
    """The reference in fp8 in the program's place reads above each of the
    cell's limits (the CPU at B2 x 3 steps)."""
    H, _, _ = bench
    import control

    cell = H.load_cell(H.load_spec(), CELL)
    cell.traffic.update(batch=2, steps=3, inputs=2)
    (row,) = control.read_seeds(cell, [2**31 + 282], 1, 0.1, torch.device("cpu"), lambda: None,
                                log=lambda s: None)
    for k, lim in cell.limits["numbers"].items():
        assert row["program"][k] <= lim["limit"] < row["control"][k], k
