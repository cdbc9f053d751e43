"""Kernel 1's FiLM plan on the CPU: ``pack_cond_simple_cnn``'s layouts,
``fused_cond_rollout_plain`` (the plan's rounding points) against the
``CondSimpleCNN.step`` loop, the wrapper's CPU route and refusals, and the
rollout driver, which keeps the module loop on the CPU. The kernel itself
runs only on the card (``chip_smoke.check_cond_rollout``).

Models are seeded with ``init_weights_`` and their zero-initialised gates
(``cond_conv1.2``, ``cond_conv2.3``) filled too: at zero the gated conv and
the FiLM scale vanish and no comparison would see them.
"""

import math

import pytest
import torch

from lns_tpu_torch.config import twophase_conditional_config
from lns_tpu_torch.kernels.prop_rollout import (PackedCondSimpleCNN, cond_terms, film_takes,
                                                fused_cond_rollout, fused_cond_rollout_plain,
                                                pack_cond_simple_cnn)
from lns_tpu_torch.models import CondSimpleCNN, LatentDynamics, latent_dynamics
from lns_tpu_torch.ops.initializers import init_weights_
from lns_tpu_torch.utils import profiling

# (latent_dim, n_block, C): the test size, and the conditional config's
# widths (C_lat 64, C 128, 4 blocks) that the FiLM plan takes on the card
WIDTHS = {"tiny": (16, 2, 32), "full": (64, 4, 128)}


def _open_gates(module, gen):
    """Fill the zero-initialised gates as ``init_weights_`` fills a conv."""
    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
    return module


def _cnn(width, dtype=None, seed=0):
    c_lat, n_block, c = WIDTHS[width]
    gen = torch.Generator().manual_seed(seed)
    cnn = CondSimpleCNN(c_lat, 16, n_block, c, dilation=2, padding_mode="zeros", dtype=dtype)
    return _open_gates(init_weights_(cnn, gen), gen).eval()


def _inputs(cnn, b, seed=1):
    c_lat = cnn.in_proj.weight.shape[1]
    gen = torch.Generator().manual_seed(seed)
    z0 = torch.randn(b, 7, 15, c_lat, generator=gen)
    param = torch.rand(b, generator=gen) * 0.6 + 0.3
    return z0, param


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_cond_simple_cnn_layouts(dtype):
    """Every packed tensor is the module's weight in the kernel's layout:
    matrices [in, out] and conv taps HWIO in `dtype`, the three GroupNorms
    and three convs of a block in the step's order, biases and GN
    parameters in f32, all contiguous."""
    cnn = _cnn("tiny")
    p = pack_cond_simple_cnn(cnn, dtype)
    assert isinstance(p, PackedCondSimpleCNN)
    c_lat, n_block, c = WIDTHS["tiny"]
    shapes = {"in_w": (c_lat, c), "in_b": (c,), "gn_s": (n_block, 3, c),
              "gn_b": (n_block, 3, c), "conv_w": (n_block, 3, 3, 3, c, c),
              "conv_b": (n_block, 3, c), "ffn_w": (n_block, 2, c, c), "out_gn_s": (c,),
              "out_gn_b": (c,), "out_w": (c, c_lat), "out_b": (c_lat,)}
    for name, shape in shapes.items():
        t = getattr(p, name)
        want = dtype if name in ("in_w", "conv_w", "ffn_w", "out_w") else torch.float32
        assert tuple(t.shape) == shape and t.dtype == want and t.is_contiguous(), name
    assert torch.equal(p.in_w, cnn.in_proj.weight[:, :, 0, 0].t().to(dtype))
    assert torch.equal(p.out_w, cnn.out_proj[1].weight[:, :, 0, 0].t().to(dtype))
    assert torch.equal(p.out_gn_s, cnn.out_proj[0].gn.weight)
    for i, blk in enumerate(cnn.net):
        for j, conv in enumerate((blk.conv1[1], blk.conv1[3], blk.cond_conv1[2])):
            assert torch.equal(p.conv_w[i, j], conv.weight.permute(2, 3, 1, 0).to(dtype))
            assert torch.equal(p.conv_b[i, j], conv.bias)
        for j, gn in enumerate((blk.conv1[0], blk.cond_conv1[0], blk.ffn[0])):
            assert torch.equal(p.gn_s[i, j], gn.weight) and torch.equal(p.gn_b[i, j], gn.bias)
        for j, mat in enumerate((blk.ffn[1], blk.ffn[3])):
            assert torch.equal(p.ffn_w[i, j], mat.weight[:, :, 0, 0].t().to(dtype))


def test_cond_terms_stack_the_conditioning():
    """``cond_terms`` stacks each block's (e, c) into two [n_block, B, C]
    f32 tensors, unchanged."""
    cnn = _cnn("tiny")
    _, param = _inputs(cnn, 3)
    shared = cnn.conditioning(param)
    e, c = cond_terms(shared)
    assert e.shape == c.shape == (len(shared), 3, WIDTHS["tiny"][2])
    assert e.dtype == c.dtype == torch.float32
    for i, (ei, ci) in enumerate(shared):
        assert torch.equal(e[i], ei) and torch.equal(c[i], ci)


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_plain_rollout_f32_matches_the_module_loop(width):
    """f32: the plain rollout against ``steps`` applications of
    ``CondSimpleCNN.step`` within 1e-5 x max|ref| (summation order, and the
    module's two-pass f32 GroupNorm against the plan's single pass)."""
    cnn = _cnn(width)
    b, steps = (3, 4) if width == "tiny" else (2, 2)
    z0, param = _inputs(cnn, b)
    with torch.no_grad():
        shared = cnn.conditioning(param)
        e, c = cond_terms(shared)
        out = fused_cond_rollout_plain(z0, pack_cond_simple_cnn(cnn), e, c, steps,
                                       cnn.prop_n_block, cnn.dilation)
        z, ref = z0, []
        for _ in range(steps):
            z = cnn.step(z, shared)
            ref.append(z)
        ref = torch.stack(ref)
    assert out.shape == (steps,) + tuple(z0.shape) and out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_plain_rollout_bf16_step_by_step(width):
    """bf16: each step of the plain rollout against one ``CondSimpleCNN.step``
    of the bf16 module from the plain rollout's own carry, within 2e-2 x
    max|ref| (kernel 1's per-step bound; the module takes its f32 GroupNorms
    in two passes and its matrices through ``F.linear``: ~0.7 % of max|ref|
    here)."""
    cnn = _cnn(width, torch.bfloat16)
    b, steps = (3, 4) if width == "tiny" else (2, 2)
    z0, param = _inputs(cnn, b)
    with torch.no_grad():
        shared = cnn.conditioning(param)
        e, c = cond_terms(shared)
        z0 = z0.to(torch.bfloat16)
        out = fused_cond_rollout_plain(z0, pack_cond_simple_cnn(cnn, torch.bfloat16), e, c,
                                       steps, cnn.prop_n_block, cnn.dilation)
        assert out.dtype == torch.bfloat16
        for t in range(steps):
            ref = cnn.step(z0 if t == 0 else out[t - 1], shared).float()
            err = (out[t].float() - ref).abs().max().item()
            assert err <= 2e-2 * ref.abs().max().item(), (t, err)


def test_plain_rollout_sees_the_conditioning():
    """Another conditioning gives another rollout: e and c both enter (each
    moved per channel; a shift of e alike in every channel would vanish in
    the GroupNorm(1) after it)."""
    cnn = _cnn("tiny")
    z0, param = _inputs(cnn, 3)
    packed = pack_cond_simple_cnn(cnn)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        e, c = cond_terms(cnn.conditioning(param))
        base = fused_cond_rollout_plain(z0, packed, e, c, 2, 2, 2)
        move = torch.randn(e.shape, generator=gen) * 0.5
        for e2, c2 in ((e + move, c), (e, c + move)):
            other = fused_cond_rollout_plain(z0, packed, e2, c2, 2, 2, 2)
            assert (other - base).abs().max().item() > 1e-3 * base.abs().max().item()


def test_fused_cond_rollout_takes_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version, bitwise, and names the plain
    plan on the open span."""
    cnn = _cnn("tiny", torch.bfloat16)
    z0, param = _inputs(cnn, 2)
    with torch.no_grad():
        e, c = cond_terms(cnn.conditioning(param))
        packed = pack_cond_simple_cnn(cnn, torch.bfloat16)
        profiling.reset()
        with profiling.recording(), profiling.span("lns.rollout"):
            got = fused_cond_rollout(z0, packed, e, c, 3, 2, 2)
    want = fused_cond_rollout_plain(z0, packed, e, c, 3, 2, 2)
    assert torch.equal(got, want)
    (roll,) = profiling.spans()
    assert roll.attrs["plan"] == "plain"


@pytest.mark.parametrize("case", ["cpu", "f32", "padding", "rank"])
def test_film_takes_refuses_what_the_plan_does_not_take(case):
    """``film_takes`` is False, without asking the kernel library, for a
    CPU carry (the only device here), and also for f32, another padding or
    a carry that is not [B, H, W, C_lat]."""
    z = torch.zeros(2, 7, 15, 64, dtype=torch.bfloat16)
    pm = "zeros"
    if case == "f32":
        z = z.float()
    elif case == "padding":
        pm = "circular"
    elif case == "rank":
        z = z[0]
    assert film_takes(z, 128, pm) is False


class _Carry:
    """A carry as ``film_takes`` reads it (device, dtype, rank, shape),
    standing for a CUDA tensor where there is no card."""

    def __init__(self, *shape):
        self.shape, self.dtype, self.device = shape, torch.bfloat16, torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)


class _ShapeLimit:
    """A kernel library with the FiLM limit alone (the plan's shape rule);
    any other entry point, such as a query of the card, raises."""

    def __init__(self):
        self.asked = []

    def lns_prop_rollout_film_limit(self, b, h, w, c_lat, c, groups):
        self.asked.append((b, h, w, c_lat, c, groups))
        return None if (c, c_lat, groups) == (128, 64, 32) and h * w <= 128 else b"a limit"


@pytest.mark.parametrize("shape,takes", [((2048, 7, 15, 64), True), ((1, 7, 15, 64), True),
                                         ((2, 12, 24, 64), False), ((2, 7, 15, 16), False)])
def test_film_takes_reads_the_shape_alone(monkeypatch, shape, takes):
    """For a CUDA bf16 carry ``film_takes`` asks the library's shape limit
    once, with the carry's shape, and nothing else: no query of the card
    (``torch.cuda``, occupancy), so a kernel that the card cannot launch
    raises in ``fused_cond_rollout`` and never sends the carry to the
    module loop."""
    from lns_tpu_torch.kernels import _build

    lib = _ShapeLimit()
    monkeypatch.setattr(_build, "library", lambda: lib)
    for name in ("device", "current_device", "get_device_properties", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail("asked the card"))
    assert film_takes(_Carry(*shape), 128, "zeros") is takes
    assert lib.asked == [(*shape, 128, 32)]


def test_film_limit_asks_nothing_of_the_card():
    """The C side's FiLM limit (``lns_prop_rollout_film_limit``, and the
    ``film_limit`` and ``make_film_plan`` it reads) is a function of its
    arguments: its source calls no CUDA runtime function and not the
    occupancy query ``film_at_once``."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).parents[1] / "lns_tpu_torch" / "csrc"
           / "prop_rollout.cu").read_text()
    for head in ('extern "C" const char* lns_prop_rollout_film_limit(',
                 "const char* film_limit(", "FilmPlan make_film_plan("):
        start = src.index(head)
        body = src[start:src.index("\n}\n", start)]
        code = re.sub(r"//[^\n]*", "", body)
        assert "cuda" not in code and "film_at_once" not in code, head


def test_film_step_bound_rejects_a_bf16_stretch():
    """``chip_smoke.py`` holds the FiLM plan's steps to FILM_STEP_RMS in the
    rms distance from the plain version; its control, the plain step with
    the f32 stretch (u and the FiLM product, their GroupNorms and the GELU)
    in bf16, reads above that bound here too, at the published widths."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cnn = _cnn("full", torch.bfloat16)
    z0, param = _inputs(cnn, 8, seed=5)
    packed = pack_cond_simple_cnn(cnn, torch.bfloat16)
    with torch.no_grad():
        e, c = cond_terms(cnn.conditioning(param))
        z = fused_cond_rollout_plain(z0, packed, e, c, 2, 4, 2)[-1]
        one = fused_cond_rollout_plain(z, packed, e, c, 1, 4, 2)
        ctl = smoke._film_bf16_stretch(z, packed, e, c, 4, 2)[None]
    assert smoke._rms_ratio(one, one) == 0
    assert smoke._rms_ratio(ctl, one) > smoke.FILM_STEP_RMS


def test_fused_cond_rollout_plain_route_keeps_autograd():
    """On the CPU the plain version runs under autograd (the kernel's route
    refuses an input that requires grad, ``_build.on_cuda``)."""
    cnn = _cnn("tiny")
    z0, param = _inputs(cnn, 2)
    e, c = cond_terms(cnn.conditioning(param))
    out = fused_cond_rollout(z0, pack_cond_simple_cnn(cnn), e, c, 1, 2, 2)
    assert out.requires_grad  # e and c carry the conditioning's graph


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rollout_driver_keeps_the_module_loop_on_the_cpu(dtype):
    """On the CPU a conditional predict steps as modules in either dtype:
    ``LOOP_STEPS`` grows by batch x steps, ``lns.rollout`` takes the loop
    path and names no plan, and no kernel launches."""
    cfg = twophase_conditional_config().replace(
        Ly=31, Lx=61, resolutions=[31, 61], latent_dim=16, encoder_channels=[32, 32, 32, 32],
        decoder_channels=[32, 32, 32], decoder_attn_heads=2, decoder_attn_dim=16,
        prop_n_block=2, prop_n_embd=32)
    torch.manual_seed(0)
    model = LatentDynamics(cfg, dtype=dtype, ae_dtype=dtype, device="cpu").eval()
    gen = torch.Generator().manual_seed(2)
    x, cond = torch.randn(3, 31, 61, 4, generator=gen), torch.rand(3, generator=gen)
    key = latent_dynamics.LOOP_STEPS
    before = profiling.counters()
    profiling.reset()
    with profiling.recording():
        zs = model.predict_latents(x, 4, cond)
    after = profiling.counters()
    assert zs.shape == (3, 4, 7, 15, 16)
    assert after.get(key, 0) - before.get(key, 0) == 3 * 4
    launched = "prop_rollout.fused_cond_rollout.launches"
    assert after.get(launched, 0) == before.get(launched, 0)
    (roll,) = [r for r in profiling.spans() if r.name == "lns.rollout"]
    assert roll.attrs["path"] == "loop" and "plan" not in roll.attrs
