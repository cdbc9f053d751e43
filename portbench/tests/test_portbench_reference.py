"""The plain reference (``reference/lns.py``) against the port's plain path
on the CPU, its exact rewritings against the published forms in float64,
and the model FLOPs it counts (``work.py``)."""

import pytest
import torch
import torch.nn.functional as F

import harness as H
from reference import lns
from work import predict_work

CELLS = {"ns2d": "ns2d.rollout.b32", "sw": "sw.rollout.b8"}


def _cell(config):
    return H.load_cell(H.load_spec(), CELLS[config])


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("config", sorted(CELLS))
def test_reference_matches_port_plain_path(config):
    """encode, one step and decode of the reference against the port with
    every kernel replaced by its plain version, f32, on the benchmark's
    state dict (loaded with strict=True)."""
    from lns_tpu_torch.config import Config
    from lns_tpu_torch.models import LatentDynamics

    cell = _cell(config)
    gen = H.generator(5, "cpu")
    state = H.make_state_dict(lns, cell.widths, gen, "cpu")
    model = LatentDynamics(Config(**cell.widths), device="cpu")
    model.load_state_dict(state, strict=True)
    model.use_kernels(False)
    ref = lns.LNS(cell.widths, state)
    w = cell.widths
    x = torch.randn(1, w["Ly"], w["Lx"], w["in_channels"], generator=gen)
    with torch.no_grad():
        z = model.encode(x)
        assert _rel(ref.encode(x), z) < 1e-4
        z1 = model.propagator(z)
        assert _rel(ref.step(z), z1) < 1e-4
        assert _rel(ref.decode(z1), model.decode(z1)) < 1e-4


# GFLOP per frame as FlopCounterMode counts the port's plain path on the CPU
FLOPS = {"ns2d": (1.3451, 0.18298, 1.0228), "sw": (7.5474, 1.1230, 5.9846)}


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_flop_counts(config):
    cell = _cell(config)
    work = predict_work(lns, cell.widths, 2, 3, True)
    for got, want in zip((work["encode"], work["step"], work["decode"]), FLOPS[config]):
        assert round(got / 1e9, len(str(want).split(".")[1])) == want  # to the digits given
    assert work["flops"] == 2 * work["encode"] + 6 * work["step"] + 6 * work["decode"]


def _published_conv(x, w, mode):
    """A 3x3 stride-1 pad-1 conv with `mode`'s padding, as written."""
    if mode == "circular":
        x = F.pad(x, (1, 1, 1, 1), mode="circular")
    elif mode == "hpx":
        x = F.pad(F.pad(x, (1, 1, 0, 0), mode="circular"), (0, 0, 1, 1))
    else:
        x = F.pad(x, (1, 1, 1, 1))
    return F.conv2d(x, w)


@pytest.mark.parametrize("mode", ["circular", "hpx", "zeros"])
def test_up2x_conv_is_upsample_then_conv(mode):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 6, 10, generator=g, dtype=torch.float64)
    w = torch.randn(7, 5, 3, 3, generator=g, dtype=torch.float64)
    want = _published_conv(F.interpolate(x, scale_factor=2, mode="nearest"), w, mode)
    torch.testing.assert_close(lns.up2x_conv(x, w, mode), want, rtol=1e-12, atol=1e-12)


def test_strip_conv_is_half_periodic_conv():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 4, 6, 9, generator=g, dtype=torch.float64)
    w = torch.randn(3, 4, 3, 3, generator=g, dtype=torch.float64)
    torch.testing.assert_close(lns.strip_conv(x, w), _published_conv(x, w, "hpx"),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("hw", [(8, 8), (6, 12)])
def test_fab_core_is_the_published_block(hw):
    """Both forms of the core (the published one that judges, the
    channel-space one that is counted) against FABlock2D as written here:
    in_proj, the axial kernels on the value, InstanceNorm2d (two-pass),
    out_fc1."""
    g = torch.Generator().manual_seed(3)
    b, (h, w), c, n, d, o = 2, hw, 5, 3, 4, 6
    f64 = dict(generator=g, dtype=torch.float64)
    u, kx, ky = torch.randn(b, h, w, c, **f64), torch.randn(b, n, h, h, **f64), torch.randn(b, n, w, w, **f64)
    w_in, w_o1 = torch.randn(c, n, d, **f64), torch.randn(n, d, o, **f64)
    phi = torch.einsum("bhwc,cnd->bnhwd", u, w_in)
    x = torch.einsum("bnlw,bnhwd->bnhld", ky, torch.einsum("bnih,bnhwd->bniwd", kx, phi))
    mean = x.mean(dim=(2, 3), keepdim=True)
    xn = (x - mean) / torch.sqrt((x - mean).square().mean(dim=(2, 3), keepdim=True) + 1e-5)
    want = torch.einsum("bnhwd,ndo->bhwo", xn, w_o1)
    ref = lns.LNS.__new__(lns.LNS)
    ref.fp8 = False
    for core in (ref.fab_core, ref.fab_core_channel):
        torch.testing.assert_close(core(u, kx, ky, w_in, w_o1), want, rtol=1e-9, atol=1e-9)


def test_lower_precision_rounds_every_layer():
    """The control's fp8 form differs from the reference by far more than
    the program's bf16 does, and saturates instead of overflowing."""
    cell = _cell("ns2d")
    state = H.make_state_dict(lns, cell.widths, H.generator(6, "cpu"), "cpu")
    x = torch.randn(1, 64, 64, 1, generator=torch.Generator().manual_seed(7))
    exact = lns.LNS(cell.widths, state).encode(x)
    fp8 = lns.LNS(cell.widths, state, fp8=True).encode(x)
    assert torch.isfinite(fp8).all() and _rel(fp8, exact) > 0.1
    big = lns.LNS(cell.widths, state, fp8=True)._q(torch.tensor([1e6]))
    assert float(big) == 448.0
