"""The port's spans and counters (``lns_tpu_torch.utils.profiling``) on the
CPU, through a tiny NS2d ``LatentDynamics``: off without a profiler or
``recording()``; under a CPU ``torch.profiler`` one span per phase of
``predict`` in a tree that shares the predict's id, each containing its
range in the profiler's events; no wrapper launching, counting scratch or
host time on the CPU (kernel 1's sample-plan counter included, its rollout
span naming the plain plan); a conditional predict's ``lns.conditioning``
span and the module loop's step counter; kernel 2's scratch sized as at
SW's 48x96 b336; and
the benchmark's readers of the spans and counters
(``portbench/metrics/{propagator,kernels}.*.py``) at a test's size."""

import collections
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lns_tpu_torch.config import ns2d_config, twophase_conditional_config
from lns_tpu_torch.kernels import fab_core
from lns_tpu_torch.models import LatentDynamics, latent_dynamics
from lns_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
WRAPPERS = ("prop_rollout.fused_rollout", "fab_core.fab_fused_core",
            "group_norm.fused_group_norm_swish", "axial.fab_axial_in_fused",
            "axial.axial_kernel_apply_headmajor", "axial_pipeline.bmm_blockdiag",
            "axial_pipeline.transpose_hw", "blocked_copy.blocked_copy",
            "fab_mega.fab_mega_stats", "fab_mega.fab_mega_apply", "fab_mega.interior_dot",
            "mosaic_dots.dot_general", "mosaic_dots.dot_chain")
METRICS = ("propagator.pack_ms", "kernels.wrapper_host_ms", "kernels.launches",
           "kernels.scratch_mb", "propagator.conditioning_ms", "propagator.loop_steps")
SLACK_NS = 500_000  # a range may start or end this far outside its span (busy test hosts)


@pytest.fixture(scope="module")
def model():
    """NS2d at test size (32x32 field, 4x4 latent, FABs at 8x8 and 16x16),
    bf16 as the benchmark serves it."""
    torch.manual_seed(0)
    cfg = ns2d_config(res=32, latent_res=4).replace(
        encoder_channels=[32, 32, 32, 64, 64], decoder_channels=[64, 64, 32, 32],
        attn_resolutions=[8, 16], attn_heads=4, attn_dim=16, prop_n_block=2, prop_n_embd=32)
    return LatentDynamics(cfg, dtype=torch.bfloat16, ae_dtype=torch.bfloat16,
                          device="cpu").eval()


def _x():
    return torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def cond_model():
    """The conditional two-phase family at test size (31x61x4 field, 7x15x16
    latent, a 2 x 32 CondSimpleCNN), bf16."""
    torch.manual_seed(0)
    cfg = twophase_conditional_config().replace(
        Ly=31, Lx=61, resolutions=[31, 61], latent_dim=16, encoder_channels=[32, 32, 32, 32],
        decoder_channels=[32, 32, 32], decoder_attn_heads=2, decoder_attn_dim=16,
        prop_n_block=2, prop_n_embd=32)
    return LatentDynamics(cfg, dtype=torch.bfloat16, ae_dtype=torch.bfloat16,
                          device="cpu").eval()


def _cond_args():
    gen = torch.Generator().manual_seed(2)
    return torch.randn(3, 31, 61, 4, generator=gen), torch.rand(3, generator=gen) * 0.6 + 0.3


def _profiled(model):
    """The spans and the profiler of one predict, B2 x 2 steps, its 4
    frames decoded in 2 chunks, under a CPU profiler."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.predict(_x(), 2, decode_chunk=2)
    return profiling.spans(), prof


def _children(records, parent):
    return [r.name for r in sorted(records, key=lambda r: r.start_ns) if r.parent == parent.id]


def test_spans_are_off_without_profiler_or_recording(model, monkeypatch):
    """Off, predict records nothing and opens no profiler range."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    assert not profiling.on() and profiling.clock() == 0
    model.predict(_x(), 2, decode_chunk=2)
    model.predict_latents(_x(), 2)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_recording_keeps_spans_without_a_profiler_range(model, monkeypatch):
    """Inside ``recording()`` with no profiler the spans record, and no
    range is opened for them; ``predict_latents`` alone is a predict."""
    monkeypatch.setattr(torch.profiler, "record_function", None)
    profiling.reset()
    with profiling.recording():
        assert profiling.on() and profiling.clock() > 0
        model.predict_latents(_x(), 3)
    assert not profiling.on()
    records = profiling.spans()
    (root,) = [r for r in records if r.parent is None]
    assert root.name == "lns.predict" and root.attrs["to_x"] is False
    assert root.attrs["steps"] == 3 and _children(records, root) == ["lns.encode", "lns.propagate"]


def test_predict_spans_form_its_tree_under_the_profiler(model):
    records, _ = _profiled(model)
    assert len(records) == 7
    (root,) = [r for r in records if r.parent is None]
    assert root.name == "lns.predict" and root.nth == 0
    assert {k: root.attrs[k] for k in ("batch", "steps", "to_x", "decode_chunk")} == {
        "batch": 2, "steps": 2, "to_x": True, "decode_chunk": 2}
    assert _children(records, root) == ["lns.encode", "lns.propagate", "lns.decode",
                                        "lns.decode"]
    (prop,) = [r for r in records if r.name == "lns.propagate"]
    assert _children(records, prop) == ["lns.pack", "lns.rollout"]
    assert all(r.predict == root.id for r in records)
    decodes = sorted((r for r in records if r.name == "lns.decode"), key=lambda r: r.start_ns)
    assert [(r.nth, r.attrs["frames"]) for r in decodes] == [(0, 2), (1, 2)]
    (enc,) = [r for r in records if r.name == "lns.encode"]
    (roll,) = [r for r in records if r.name == "lns.rollout"]
    assert enc.attrs == {"frames": 2} and roll.attrs == {
        "steps": 2, "path": "kernel", "plan": "plain", "samples_per_block": None}
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            up = next(p for p in records if p.id == r.parent)
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns


def test_spans_contain_their_profiler_ranges(model):
    """Each span's interval, on ``time.time_ns()``, holds the range it
    opened in the profiler's events, on the profiler's clock."""
    records, prof = _profiled(model)
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lns."):
            ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    by_name = collections.defaultdict(list)
    for r in sorted(records, key=lambda r: r.start_ns):
        by_name[r.name].append(r)
    assert {k: len(v) for k, v in ranges.items()} == {k: len(v) for k, v in by_name.items()}
    for name, spans in by_name.items():
        for r, (start, end) in zip(spans, sorted(ranges[name])):
            assert r.start_ns - SLACK_NS <= start <= end <= r.end_ns + SLACK_NS, name


def test_no_wrapper_launches_on_the_cpu(model):
    """On the CPU every wrapper takes its plain version: the predict's
    counter changes hold no launch, scratch byte or host time."""
    profiling.reset()
    with profiling.recording():
        model.predict(_x(), 2, decode_chunk=2)
        model.use_kernels(False).predict(_x(), 2)
    model.use_kernels(True)
    roots = [r for r in profiling.spans() if r.name == "lns.predict"]
    assert len(roots) == 2
    for root in roots:
        deltas = root.attrs["counters"]
        for w in WRAPPERS:
            for k in ("launches", "scratch_bytes", "host_ns"):
                assert deltas.get(f"{w}.{k}", 0) == 0
    loop = [r for r in profiling.spans() if r.name == "lns.rollout"][-1]
    assert loop.attrs["path"] == "loop"


def test_no_sample_plan_launch_on_the_cpu(model):
    """Kernel 1's sample-plan counter stays at 0 through CPU predicts (the
    plain version launches nothing), and its rollout span names the plain
    plan."""
    key = "prop_rollout.fused_rollout.sample_plan"
    before = profiling.counters().get(key, 0)
    profiling.reset()
    with profiling.recording():
        model.predict(_x(), 2, decode_chunk=2)
        model.predict_latents(_x(), 3)
    assert profiling.counters().get(key, 0) == before
    roots = [r for r in profiling.spans() if r.name == "lns.predict"]
    assert len(roots) == 2 and all(key not in r.attrs["counters"] for r in roots)
    rolls = [r for r in profiling.spans() if r.name == "lns.rollout"]
    assert [(r.attrs["plan"], r.attrs["samples_per_block"]) for r in rolls] == [("plain", None)] * 2


def test_rollout_span_carries_the_plan_and_samples_per_block(model):
    """Under the profiler as under ``recording()``, ``lns.rollout`` on the
    kernel path carries the wrapper's plan and samples per block; the step
    loop (kernels off) carries neither."""
    records, _ = _profiled(model)
    (roll,) = [r for r in records if r.name == "lns.rollout"]
    assert {"plan", "samples_per_block"} <= set(roll.attrs)
    profiling.reset()
    with profiling.recording():
        model.use_kernels(False).predict_latents(_x(), 2)
    model.use_kernels(True)
    (loop,) = [r for r in profiling.spans() if r.name == "lns.rollout"]
    assert loop.attrs == {"steps": 2, "path": "loop"}


def test_conditioning_span_once_per_conditional_predict(model, cond_model):
    """A conditional predict opens one ``lns.conditioning`` (its batch),
    under the predict and before ``lns.encode``; an unconditional one none."""
    x, cond = _cond_args()
    profiling.reset()
    with profiling.recording():
        cond_model.predict(x, 2, cond)
        cond_model.predict_latents(x, 3, cond)
        model.predict(_x(), 2, decode_chunk=2)
        model.predict_latents(_x(), 2)
    records = profiling.spans()
    roots = sorted((r for r in records if r.name == "lns.predict"), key=lambda r: r.start_ns)
    assert len(roots) == 4
    for root, n in zip(roots, (1, 1, 0, 0)):
        spans = [r for r in records if r.name == "lns.conditioning" and r.predict == root.id]
        assert len(spans) == n
        if n:
            assert spans[0].parent == root.id and spans[0].attrs == {"batch": 3}
            assert _children(records, root)[:2] == ["lns.conditioning", "lns.encode"]


@pytest.mark.parametrize("path", ["kernel", "loop", "conditional"])
def test_loop_steps_counts_the_samples_the_module_loop_steps(model, cond_model, path):
    """``LOOP_STEPS`` changes by batch x steps over a predict whose steps
    run as modules (kernels off, or a conditional propagator) and by 0
    where the rollout took kernel 1's path; the root span carries it."""
    key = latent_dynamics.LOOP_STEPS
    before = profiling.counters().get(key, 0)
    profiling.reset()
    with profiling.recording():
        if path == "conditional":
            x, cond = _cond_args()
            cond_model.predict_latents(x, 4, cond)
        else:
            model.use_kernels(path == "kernel").predict(_x(), 4, decode_chunk=4)
    model.use_kernels(True)
    want = {"kernel": 0, "loop": 2 * 4, "conditional": 3 * 4}[path]
    assert profiling.counters().get(key, 0) - before == want
    (root,) = [r for r in profiling.spans() if r.name == "lns.predict"]
    assert root.attrs["counters"].get(key, 0) == want
    (roll,) = [r for r in profiling.spans() if r.name == "lns.rollout"]
    assert roll.attrs["path"] == ("kernel" if path == "kernel" else "loop")


def test_annotate_adds_to_the_innermost_open_span():
    """``annotate`` adds its attrs to the innermost open span of the
    thread, and does nothing while spans are off or outside every span."""
    profiling.reset()
    profiling.annotate(ignored=1)
    with profiling.span("outside"):
        pass
    assert profiling.spans() == []
    with profiling.recording():
        profiling.annotate(ignored=2)
        with profiling.span("outer", a=1):
            with profiling.span("inner"):
                profiling.annotate(plan="samples", samples_per_block=2)
            profiling.annotate(b=3)
    by = {r.name: r.attrs for r in profiling.spans()}
    assert by == {"inner": {"plan": "samples", "samples_per_block": 2}, "outer": {"a": 1, "b": 3}}


def test_launched_counts_into_one_registry():
    key = "tests.fake_wrapper"
    before = profiling.counters()
    profiling.launched(key, 128)
    profiling.launched(key, 64, time.perf_counter_ns() - 1000)
    profiling.count(f"{key}.launches", 3)
    after = profiling.counters()
    change = {k: after[k] - before.get(k, 0) for k in after if k.startswith(key)}
    assert change[f"{key}.launches"] == 5 and change[f"{key}.scratch_bytes"] == 192
    assert change[f"{key}.host_ns"] >= 1000


def test_span_buffer_keeps_the_newest_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    profiling.reset()
    with profiling.recording():
        for i in range(5):
            with profiling.span("tests.span", i=i):
                pass
    assert [r.attrs["i"] for r in profiling.spans()] == [2, 3, 4] and profiling.dropped() == 2
    assert [r.predict for r in profiling.spans()] == [None] * 3
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_fab_core_scratch_at_sw_48x96_b336():
    """Kernel 2's scratch at SW's largest FAB site (b336, 8 heads, c 64):
    the bb scratch and the Gram as the kernel table has them."""
    got = fab_core.scratch_bytes(336, 8, 48, 96, 64, 64, torch.bfloat16)
    assert got["bb"] == 1_585_446_912 and got["gram"] == 44_040_192
    assert set(got) == {"m", "bias", "bb", "mean", "gram"}
    assert set(fab_core.scratch_bytes(2, 2, 8, 8, 64, 64, torch.float32)) == {"m", "bias"}


def _portbench(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "portbench"))
    import harness

    return harness


def test_benchmark_reads_the_program_spans_on_the_cpu(monkeypatch):
    """A traced run of a cell at a test's size reads the pack's span; the
    kernel metrics find no launch on the CPU and are left out."""
    H = _portbench(monkeypatch)
    import run

    cell = H.load_cell(H.load_spec(), "ns2d.rollout.b32")
    cell.traffic.update(batch=1, steps=2, inputs=2)
    profiling.reset()
    r = run.run_cell(cell, 2**31 + 9, 0.4, True, torch.device("cpu"), 0.0)
    assert r["correct"] and r["metrics"]["propagator.pack_ms"]["value"] > 0
    assert r["metrics"]["propagator.loop_steps"]["value"] == 0
    assert not {"kernels.launches", "kernels.scratch_mb", "kernels.wrapper_host_ms"} & set(
        r["metrics"])


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_nothing_from_a_program_without_spans(monkeypatch, name):
    """Against a program that records no spans (the port before them) each
    new reader returns None and raises nothing."""
    H = _portbench(monkeypatch)
    monkeypatch.delattr(profiling, "spans")
    assert H.load_metric(name).read(SimpleNamespace(traced=H.Window())) is None


def test_loop_steps_reader_reads_nothing_without_the_counter(monkeypatch):
    """A program that records spans but has no ``LOOP_STEPS`` (the port
    before it) reads nothing, where one that has it reads 0 without a
    loop step."""
    H = _portbench(monkeypatch)
    reader = H.load_metric("propagator.loop_steps")
    profiling.reset()
    with profiling.recording():
        with profiling.span("lns.predict", root=True):
            pass
    ctx = SimpleNamespace(traced=SimpleNamespace(count=1))
    assert reader.read(ctx) == 0
    monkeypatch.delattr(latent_dynamics, "LOOP_STEPS")
    assert reader.read(ctx) is None
