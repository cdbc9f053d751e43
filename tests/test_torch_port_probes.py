"""The port's probe kernels against the TPU probe scripts' Pallas kernels, run
in interpret mode on the CPU: ``blocked_copy`` and kernel 6 against
``benchmarks/probe_pallas_bw.py``, the layout forms of
``kernels/probe_layouts.py`` against ``benchmarks/probe_mosaic.py``, and
``interior_dot``, ``fab_mega_stats`` and ``fab_mega_apply`` against
``benchmarks/probe_fab_mega.py``. On the CPU each wrapper takes its plain
version, so these hold the plain versions (and the port's forms built on
the wrappers) to the Pallas kernels.

Each probe is loaded from its file, with its module-level setting of JAX's
compilation cache put back right after, and runs its kernels through a
stand-in for its ``pl`` whose ``pallas_call`` drops the TPU compiler
parameters, runs in interpret mode and records each call's operands and
output. The probes' shapes are cut (``probe_fab_mega``: B, N = 2, 2 at its
32x32 c64; the copy [8, 2, 16, 128]).

Tolerances: copies, reshapes and the transpose bitwise. The products sum in
f32 on both sides and round to the dtype once, so f32 results are held to
the sum-order bound 1e-6 x max|ref|, and bf16 results to a share of
elements that differ, each by at most one bf16 ulp of max|ref| (2^-8 x
max|ref|; the share is where a sum in another order rounds the other way):
``BF16_SHARE``. G and s are f32 sums of 1,024 rows of b2, bf16 values that
come from f32 sums: G within 2e-5 x max|ref| (measured 6.9e-6) and s within
1e-4 x max|ref| (measured 3.2e-5: one b2 element rounded the other way
moves its column sum by its ulp, 1.2e-4).
"""

import functools
import importlib.util
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lns_tpu_torch.kernels import (axial_pipeline, blocked_copy, fab_mega, mosaic_dots, probe_bw,
                                   probe_fab_mega, probe_layouts)

ROOT = Path(__file__).resolve().parent.parent
BF16_SHARE = 0.01  # at most 1 % of bf16 elements one rounding apart
F32_TOL = 1e-6
G_TOL, S_TOL = 2e-5, 1e-4


class _InterpretPl:
    """A probe's ``pl`` with ``pallas_call`` in interpret mode, without the
    TPU's compiler parameters, recording (operands, output) of each call
    made outside a trace."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, compiler_params=None, **kw):
        fn = pl.pallas_call(*args, interpret=True, **kw)

        def call(*operands):
            out = fn(*operands)
            self.calls.append((operands, out))
            return out

        return call


@functools.lru_cache(maxsize=None)
def _probe(name):
    """benchmarks/<name>.py as a module with `pl` replaced; the probe's
    compilation-cache setting is undone and its cache directory not made."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        with mock.patch.object(os, "makedirs"):
            spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    mod.pl = _InterpretPl()
    return mod


def _t(a):
    """A JAX or numpy array as a torch tensor of the same dtype (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16_close(out, ref, share=BF16_SHARE):
    """bf16 `out` against `ref`: at most `share` of the elements differ, each
    by at most one bf16 ulp of max|ref|."""
    o, r = out.float(), ref.float()
    differ = (o != r).float().mean().item()
    err = (o - r).abs().max().item()
    scale = r.abs().max().item()
    assert differ <= share and err <= 2.0 ** -8 * scale, (differ, err, scale)


def _f32_close(out, ref, tol=F32_TOL):
    err = (out - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


def _close(out, ref):
    if ref.dtype == torch.bfloat16:
        _bf16_close(out, ref)
    else:
        _f32_close(out, ref)


# -- probe_pallas_bw: the blocked copy and kernel 6 --------------------------

@pytest.mark.parametrize("s,shape,dtype", [
    (2, (8, 2, 16, 128), jnp.bfloat16), (4, (8, 2, 16, 128), jnp.bfloat16),
    (8, (8, 2, 16, 128), jnp.bfloat16),
    # rows of 35 bytes: on the card the per-thread route's (not a multiple of 16)
    (2, (8, 2, 7, 5), jnp.uint8)])
def test_blocked_copy_matches_pallas_copy(s, shape, dtype):
    bw = _probe("probe_pallas_bw")
    x = (jax.random.uniform(jax.random.key(0), shape) * 200).astype(dtype)
    ref = _t(bw.pallas_copy(x, s))
    xt = _t(x)
    out = blocked_copy.blocked_copy(xt, s)
    assert out.dtype == xt.dtype and torch.equal(out, ref) and torch.equal(out, xt)
    assert blocked_copy.blocked_copy.route == "plain"


def _source_edits():
    from lns_tpu_torch.kernels import probe_bw, probe_dots, probe_fab_core, probe_fab_mega

    cases = {f"probe_bw {name}": ("blocked_copy.cu", edits)
             for name, edits in probe_bw.VARIANTS.items()}
    for name, edits in {**probe_dots.VARIANTS, **probe_dots.ABLATIONS}.items():
        cases[f"probe_dots {name}"] = ("mosaic_dots.cu", edits)
    cases["probe_fab_mega phases"] = ("fab_mega.cu",
                                      probe_fab_mega.MARKS + probe_fab_mega.APPLY_MARKS)
    for name, edits in probe_fab_mega.VARIANTS.items():
        cases[f"probe_fab_mega {name}"] = ("fab_mega.cu", edits)
    for name, edits in probe_fab_core.VARIANTS.items():
        cases[f"probe_fab_core {name} + marks"] = ("fab_core.cu", edits + probe_fab_core.MARKS)
    return cases


@pytest.mark.parametrize("case", list(_source_edits()))
def test_probe_source_edits_apply(case):
    """Every edited copy of a kernel source that a card probe builds
    (``_probe.use_copy``) finds its anchors in today's source, and changes
    it; an anchor that is gone raises."""
    from lns_tpu_torch.kernels import _build, _probe

    source, edits = _source_edits()[case]
    src = (_build.SOURCE_DIR / source).read_text()
    out = _probe.edited(src, edits, case)
    assert out != src and all(new in out for _, new in edits[-1:])
    with pytest.raises(RuntimeError, match="anchor not found"):
        _probe.edited(src, [("no such anchor", "")], case)


def test_blocked_copy_any_dtype_and_view():
    x = torch.arange(3 * 5 * 7, dtype=torch.int16).reshape(3, 5, 7).transpose(0, 1)
    out = blocked_copy.blocked_copy(x, 2)
    assert out.is_contiguous() and torch.equal(out, x)


def test_bmm_blockdiag_matches_pallas_bmm():
    bw = _probe("probe_pallas_bw")
    b, g, m, n = 8, 2, 16, 128
    x = jax.random.normal(jax.random.key(0), (b, g, m, n)).astype(jnp.bfloat16)
    kb = (jax.random.normal(jax.random.key(1), (b, g, m, m)).astype(jnp.bfloat16) / m)
    ref = _t(bw.pallas_bmm(kb, x, 2))
    out = axial_pipeline.bmm_blockdiag(_t(kb), _t(x))
    _bf16_close(out, ref)
    assert torch.equal(out, axial_pipeline.bmm_blockdiag_plain(_t(kb), _t(x)))


# -- probe_mosaic: the layout forms ------------------------------------------

_MOSAIC = {"lane_merge_reshape": "probe_lane_merge_reshape",
           "lane_split_reshape": "probe_lane_split_reshape",
           "transpose_4d": "probe_transpose_4d", "rank3_dot": "probe_rank3_dot",
           "fused_axial": "probe_fused_axial"}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("form", list(_MOSAIC))
def test_probe_layouts_match_probe_mosaic(form, dtype):
    mosaic = _probe("probe_mosaic")
    calls = mosaic.pl.calls
    del calls[:]
    # the probe's own check against its f32 reference is left out: the port
    # is held to the Pallas kernel's output. That reference does not round
    # the row dot to bf16, and in interpret mode the bf16 fused_axial kernel
    # misses it in 50 of 262,144 elements (rtol 5e-2, atol 5e-1)
    with mock.patch.object(np.testing, "assert_allclose"):
        getattr(mosaic, _MOSAIC[form])(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    (operands, ref), = calls
    args = [_t(a) for a in operands]
    ref = _t(ref)
    kern, plain = probe_layouts.forms(probe_layouts.KERNELS), probe_layouts.forms(
        probe_layouts.PLAIN)
    out = kern[form][0](*args)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out, plain[form][0](*args))
    if form in probe_layouts.TOL:
        _close(out, ref)
    else:
        assert torch.equal(out, ref)


# -- probe_fab_mega: the pieces, the statistics and apply passes -------------

def _fab_mega():
    mod = _probe("probe_fab_mega")
    mod.B, mod.N = 2, 2
    return mod


@pytest.mark.parametrize("name", list(probe_fab_mega.pieces(probe_fab_mega.PLAIN)))
def test_fab_mega_pieces_match_pallas(name):
    mega = _fab_mega()
    recorded = []
    with mock.patch.object(mega, "piece", lambda *a: recorded.append(a)):
        mega.run_pieces()
    by_name = {r[0].split(" ")[0]: r for r in recorded}
    _, kernel, operands, out_shape = by_name[name.split(" ")[0]]
    ref = _t(pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(*operands))
    a3 = _t(operands[0])
    kx = _t(operands[1]) if len(operands) > 1 else torch.zeros(mega.H, mega.H,
                                                                dtype=torch.bfloat16)
    a2 = a3.reshape(mega.H, -1)
    if name.startswith("D"):  # its one operand is the [l, h c] array
        a2, a3 = a3, a3.reshape(mega.H, mega.W, mega.C)
    out = probe_fab_mega.pieces(probe_fab_mega.KERNELS)[name](a3, kx, a2)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.equal(out, probe_fab_mega.pieces(probe_fab_mega.PLAIN)[name](a3, kx, a2))
    if name in probe_fab_mega.DOTS:
        _bf16_close(out, ref)
    else:
        assert torch.equal(out, ref)


def _pass_inputs(mega):
    b, n, h, w, c = mega.B, mega.N, mega.H, mega.W, mega.C
    u = mega.mk(0, (b, h, w, c))
    return (u, jnp.swapaxes(u, 1, 2), mega.mk(1, (b, n, h, h), 1 / h),
            mega.mk(2, (b, n, w, w), 1 / w), mega.mk(3, (b, n, c, c), 1 / c), mega.mk(4, (b, c)))


@pytest.mark.parametrize("mode", ["rank3", "swap"])
def test_fab_mega_stats_matches_pallas(mode):
    mega = _fab_mega()
    _, u_t, kx, ky, _, _ = _pass_inputs(mega)
    g_ref, s_ref = mega.stats_pass(u_t, kx, ky, mode)
    g, s = fab_mega.fab_mega_stats(_t(u_t), _t(kx), _t(ky))
    assert g.dtype == s.dtype == torch.float32
    _f32_close(g, _t(g_ref), G_TOL)
    _f32_close(s, _t(s_ref)[:, :, 0], S_TOL)
    assert torch.equal(g, fab_mega.fab_mega_stats_plain(_t(u_t), _t(kx), _t(ky))[0])


def _fab_mega_stats_kernel_order(u_t, kx, ky):
    """``fab_mega_stats_plain`` in the order of sums of the kernel's wgmma
    design (``csrc/fab_mega.cu``, ``fab_mega_stats_wgmma``): the rounded b2
    as the plain version forms it; column l of b2 to warpgroup l % 2; G of
    each warpgroup summed over its columns in ascending order, one column's
    b2^T b2 (K = the 32 rows i) at a time, then the first warpgroup's + the
    second's; s per thread of a quad (u: rows i = 8 k + 2 u, + 1) summed
    over its columns in order, then k, then the pair, the quad's four added
    as (u0 + u1) + (u2 + u3), then the two warpgroups'."""
    b2 = fab_mega._b2(u_t, kx, ky)  # [b, n, (i l), c]
    b, n, _, c = b2.shape
    h, w = kx.shape[-1], ky.shape[-1]
    b2 = b2.reshape(b, n, h, w, c)  # [b, n, i, l, c]
    gs, ss = [], []
    for wg in (0, 1):
        g = torch.zeros(b, n, c, c)
        part = torch.zeros(b, n, 4, c)  # per quad lane u
        for l in range(wg, w, 2):
            col = b2[:, :, :, l]  # [b, n, i, c]
            g = g + col.transpose(-1, -2) @ col
            for k in range(h // 8):
                for e in (0, 1):
                    part = part + col[:, :, 8 * k + e:8 * k + 8:2]
        gs.append(g)
        ss.append((part[:, :, 0] + part[:, :, 1]) + (part[:, :, 2] + part[:, :, 3]))
    return gs[0] + gs[1], ss[0] + ss[1]


@pytest.mark.parametrize("mode", ["rank3", "swap"])
def test_fab_mega_stats_kernel_order(mode):
    """The wgmma statistics pass sums in another order than
    ``fab_mega_stats_plain`` (G split over two warpgroups' columns, s from
    the b2 fragments each thread holds and a quad shuffle): that order,
    emulated in plain PyTorch, against the JAX ``stats_pass`` in interpret
    mode at G_TOL / S_TOL, and against the plain version."""
    mega = _fab_mega()
    _, u_t, kx, ky, _, _ = _pass_inputs(mega)
    g_ref, s_ref = mega.stats_pass(u_t, kx, ky, mode)
    g, s = _fab_mega_stats_kernel_order(_t(u_t), _t(kx), _t(ky))
    assert g.dtype == s.dtype == torch.float32 and s.shape == (mega.B, mega.N, mega.C)
    _f32_close(g, _t(g_ref), G_TOL)
    _f32_close(s, _t(s_ref)[:, :, 0], S_TOL)
    gp, sp = fab_mega.fab_mega_stats_plain(_t(u_t), _t(kx), _t(ky))
    _f32_close(g, gp, G_TOL)
    _f32_close(s, sp, S_TOL)


@pytest.mark.parametrize("mode", ["rank3", "swap"])
def test_fab_mega_apply_matches_pallas(mode):
    mega = _fab_mega()
    _, u_t, kx, ky, m, bias = _pass_inputs(mega)
    # the Pallas kernel's BlockSpec((1, 1, C)) for the bias needs it as
    # [B, 1, C]; the probe's main() passes [B, C], which Pallas refuses
    # before any launch, so the bias is given the kernel's shape here
    ref = _t(mega.apply_pass(u_t, kx, ky, m, bias[:, None, :], mode))
    out = fab_mega.fab_mega_apply(*map(_t, (u_t, kx, ky, m, bias)))
    assert out.shape == ref.shape == (mega.B, mega.H * mega.W, mega.C)
    _bf16_close(out, ref)


def _fab_mega_apply_kernel_order(u_t, kx, ky, m, bias):
    """``fab_mega_apply_plain`` in the order of sums of the kernel's wgmma
    design (``csrc/fab_mega.cu``, ``fab_mega_apply_wgmma``): the rounded b2
    as the plain version forms it; each output (i, l, o) owned by one
    warpgroup (the one of column l's pair block), its f32 sum running over
    the heads in order, each head's b2 . m added as four k16 products (c in
    steps of 16) in k order; then minus the bias, rounded once."""
    b2 = fab_mega._b2(u_t, kx, ky)  # [b, n, (i l), c]
    mf = m.to(u_t.dtype).float()
    acc = torch.zeros(b2.shape[0], b2.shape[2], m.shape[-1])
    for hn in range(b2.shape[1]):
        for ks in range(0, b2.shape[-1], 16):
            acc = acc + b2[:, hn, :, ks:ks + 16] @ mf[:, hn, ks:ks + 16]
    return (acc - bias.to(u_t.dtype).float()[:, None, :]).to(u_t.dtype)


@pytest.mark.parametrize("mode", ["rank3", "swap"])
def test_fab_mega_apply_kernel_order(mode):
    """The wgmma apply pass sums in another order than
    ``fab_mega_apply_plain`` (the heads one after another into each
    output's running sum, four k16 products a head): that order, emulated
    in plain PyTorch, against the JAX ``apply_pass`` in interpret mode and
    against the plain version, at the bf16 tolerance (``BF16_SHARE``)."""
    mega = _fab_mega()
    _, u_t, kx, ky, m, bias = _pass_inputs(mega)
    ref = _t(mega.apply_pass(u_t, kx, ky, m, bias[:, None, :], mode))
    args = [_t(a) for a in (u_t, kx, ky, m, bias)]
    out = _fab_mega_apply_kernel_order(*args)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    _bf16_close(out, ref)
    _bf16_close(out, fab_mega.fab_mega_apply_plain(*args))


@pytest.mark.parametrize("n", [1, 3])
def test_fab_mega_apply_heads_match_pallas(n):
    """The apply pass at 1 and 3 heads, the edges of the kernel's ring of
    two slots (one head: every tile's slot in turn; three: the slots and
    the heads out of step), against the JAX ``apply_pass``."""
    mega = _fab_mega()
    mega.N = n
    _, u_t, kx, ky, m, bias = _pass_inputs(mega)
    ref = _t(mega.apply_pass(u_t, kx, ky, m, bias[:, None, :], "rank3"))
    args = [_t(a) for a in (u_t, kx, ky, m, bias)]
    out = fab_mega.fab_mega_apply(*args)
    assert out.shape == ref.shape == (mega.B, mega.H * mega.W, mega.C)
    _bf16_close(out, ref)
    _bf16_close(_fab_mega_apply_kernel_order(*args), ref)


@pytest.mark.parametrize("l_dim", [1, 11, 32])
def test_interior_dot_is_dot_general(l_dim):
    """The interior dot is one orientation of ``dot_general``: its plain
    version equals ``dot_general_plain`` contracting ((1,), (1,)) bitwise,
    and both match piece A of the TPU probe (``k_rank3_dot``) in interpret
    mode at l rows, at the pieces' bf16 tolerance (``BF16_SHARE``)."""
    mega = _fab_mega()
    recorded = []
    with mock.patch.object(mega, "piece", lambda *a: recorded.append(a)):
        mega.run_pieces()
    kernel = {r[0].split(" ")[0]: r[1] for r in recorded}["A"]
    a = mega.mk(5, (l_dim, mega.H, mega.C))
    kx = mega.mk(6, (mega.H, mega.H), 1 / mega.H)
    ref = _t(pl.pallas_call(kernel, interpret=True, out_shape=jax.ShapeDtypeStruct(
        (mega.H, l_dim, mega.C), jnp.bfloat16))(a, kx))
    out = fab_mega.interior_dot_plain(_t(kx), _t(a))
    want = mosaic_dots.dot_general_plain(_t(kx), _t(a), ((1,), (1,)), out_dtype=torch.bfloat16)
    assert out.dtype == want.dtype == torch.bfloat16 and torch.equal(out, want)
    assert torch.equal(fab_mega.interior_dot(_t(kx), _t(a)), out)
    assert out.shape == ref.shape == (mega.H, l_dim, mega.C)
    _bf16_close(out, ref)


def test_interior_dot_ragged_l():
    """l not a multiple of the kernel's 8-row tiles, against a float64 sum."""
    rng = np.random.default_rng(3)
    kx = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((11, 32, 64)).astype(np.float32))
    out = fab_mega.interior_dot(kx, a)
    assert out.shape == (32, 11, 64)
    _f32_close(out, torch.einsum("ih,lhc->ilc", kx.double(), a.double()).float())


# -- the card probes off the card --------------------------------------------

@pytest.mark.parametrize("probe", [probe_bw, probe_fab_mega, probe_layouts])
def test_card_probes_exit_without_cuda(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        probe.main()
    assert e.value.code == 1


def test_card_probes_untimed_on_cpu(monkeypatch):
    """The probes' untimed runs, as chip_smoke.py drives them, at a cut size
    on the CPU (the wrappers take their plain versions)."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(probe_fab_mega, "B", 2)
    monkeypatch.setattr(probe_fab_mega, "N", 2)
    monkeypatch.setattr(probe_bw, "SHAPE", (8, 2, 16, 128))
    res = {**probe_layouts.run(cpu, timed=False), **probe_fab_mega.run_pieces(cpu, timed=False),
           **probe_fab_mega.run_passes(cpu, timed=False)}
    assert len(res) == 17 and all(r["ok"] for r in res.values())
    rows, ok = probe_bw.run(cpu, timed=False, samples=(2, 3, 8))
    assert ok and "blocked_copy s=3" not in rows and "blocked_copy s=8" in rows
