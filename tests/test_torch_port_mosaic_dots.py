"""The port of ``benchmarks/probe_mosaic_dots.py``: its nineteen cases through
``dot_general`` and ``dot_chain`` (``lns_tpu_torch/kernels/mosaic_dots.py``)
against the Pallas kernel, run in interpret mode on the CPU. On the CPU each
wrapper takes its plain version, so these hold the plain versions, and the
port's table of cases, to the TPU probe.

The probe is loaded from its file, with its module-level setting of JAX's
compilation cache put back right after and its cache directory not made.
Each case's output shape and scratch come from the probe's own ``main()``,
run under a stand-in ``pl`` that records what each ``pallas_call`` is given
(``sys.argv`` patched); the body of each case then runs in interpret mode with
those specs. ``main()`` binds each body into a closure that it rebinds on
every pass of its loop, so the bodies are taken from the probe's ``CASES``.

Three cases cannot run on XLA's CPU backend: ``projfirst``,
``chain_projf_f32`` and ``chain_moments_f32`` contract the major dim of
both operands of ``m [C,O] . u [C,H,W]`` with bf16 operands and an f32
result, which XLA:CPU refuses at execution ("Unsupported element type for
DotThunk::Execute: BF16 x BF16 = F32"), in interpret mode and outside
Pallas alike. They run through the same interpret-mode call under a
stand-in ``jax.lax.dot_general`` that widens bf16 operands to f32 (exact)
and takes the product at precision HIGHEST, keeping the body's result
types. A product of two bf16 values is exact in f32, so this differs from
the bf16 dot only in the order of the f32 sums: on ``lhs_minor`` and
``rhs_minor``, which run both ways, at these inputs 2 and 1 of the 32,768
bf16 outputs round apart, by 6.5e-8 x max|ref|.

Tolerances (the inputs are seeded standard normals made with numpy):

  * f32 outputs whose sums no bf16 rounding follows: 1e-6 x max|ref| (the
    same exact products summed in another order; measured <= 3.3e-7);
  * bf16 outputs of one product: ``BF16_SHARE``, at most 1 % of the
    elements differ, each by at most one bf16 ulp of max|ref| (a sum in
    another order rounds the other way; measured 0.005 %);
  * the moments, ``MOMENTS_TOL`` = 1e-3 x max|ref| (measured 3.0e-4 in
    ``phi_moments``, 2.0e-4 in ``chain_moments_f32``): a phi, or a phi^2,
    rounded to bf16 the other way moves its column's sum by its ulp;
  * the chains whose bf16 intermediates can round the other way
    (``apply_chain``, ``chain_projf_f32``, ``scr_bf16_f32``,
    ``scr_f32_f32``): ``CHAIN_TOL`` = 1e-2 x max|ref|, and for a bf16
    output at most ``CHAIN_SHARE`` = 2 % of the elements differing
    (measured 1.7e-4, 1.9e-3, 8.2e-5 and 1.2e-7; 0.011 % of apply_chain's
    elements): a flipped intermediate moves every later product it feeds.
"""

import functools
import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lns_tpu_torch.kernels import _build, mosaic_dots, probe_dots
from lns_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
BF16_SHARE = 0.01
F32_TOL = 1e-6
MOMENTS_TOL = 1e-3
CHAIN_TOL, CHAIN_SHARE = 1e-2, 0.02
XLA_CPU_REFUSES = ("projfirst", "chain_projf_f32", "chain_moments_f32")
BF16_CHAINS = ("apply_chain", "chain_projf_f32", "scr_bf16_f32", "scr_f32_f32")


class _RecordingPl:
    """The probe's ``pl`` with a ``pallas_call`` that records its
    ``out_shape`` and ``scratch_shapes`` and returns zeros of that shape."""

    def __init__(self):
        self.specs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, kernel, out_shape, scratch_shapes=(), **kw):
        self.specs.append((out_shape, list(scratch_shapes)))
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)


@functools.lru_cache(maxsize=None)
def _tpu_probe():
    """benchmarks/probe_mosaic_dots.py as a module; its compilation-cache
    setting is undone and its cache directory not made."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("tpu_probe_mosaic_dots",
                                                  ROOT / "benchmarks" / "probe_mosaic_dots.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        with mock.patch.object(os, "makedirs"):
            spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    return mod


@functools.lru_cache(maxsize=None)
def _main_specs():
    """{case: (out_shape, scratch_shapes)} as the probe's main() chose them."""
    mod = _tpu_probe()
    rec = _RecordingPl()
    with mock.patch.object(mod, "pl", rec), mock.patch.object(sys, "argv", ["probe"]), \
            mock.patch.object(mod, "log", lambda msg: None):
        mod.main()
    assert len(rec.specs) == len(mod.CASES)
    return dict(zip(mod.CASES, rec.specs))


@functools.lru_cache(maxsize=None)
def _inputs():
    """The probe's six inputs, seeded standard normals in bf16, as numpy f32."""
    rng = np.random.default_rng(18)
    return {k: rng.standard_normal(s).astype(np.float32).astype(jnp.bfloat16).astype(np.float32)
            for k, s in mosaic_dots.SHAPES.items()}


def _t(a):
    """A JAX array as a torch tensor of the same dtype (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


_DOT_GENERAL = jax.lax.dot_general


def _widened_dot_general(lhs, rhs, dimension_numbers, precision=None,
                         preferred_element_type=None, **kw):
    """jax.lax.dot_general with bf16 operands widened to f32 (exact) at
    precision HIGHEST; the result in the type the body asked for."""
    def widen(x):
        return x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x

    out = _DOT_GENERAL(widen(lhs), widen(rhs), dimension_numbers,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    want = preferred_element_type or jnp.result_type(lhs, rhs)
    return out.astype(want)


@functools.lru_cache(maxsize=None)
def _pallas(key):
    """Case `key`'s body in interpret mode with main()'s specs, as torch."""
    mod = _tpu_probe()
    out_shape, scratch = _main_specs()[key]
    body = mod.CASES[key][2]
    call = pl.pallas_call(body, out_shape=out_shape, scratch_shapes=scratch, interpret=True)
    args = [jnp.asarray(v).astype(jnp.bfloat16) for v in _inputs().values()]
    if key in XLA_CPU_REFUSES:
        with mock.patch.object(jax.lax, "dot_general", _widened_dot_general):
            return _t(call(*args))
    return _t(call(*args))


def _torch_inputs():
    return {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _inputs().items()}


def _bf16_ulp(x):
    """One bf16 ulp of x (> 0): 2^(floor(log2 x) - 7)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _held(key, out, ref):
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    scale = r.abs().max().item()
    differ = (o != r).float().mean().item()
    if key in BF16_CHAINS:
        assert err <= CHAIN_TOL * scale, (err, scale)
        if ref.dtype == torch.bfloat16:
            assert differ <= CHAIN_SHARE, differ
    elif key in ("phi_moments", "chain_moments_f32"):
        assert err <= MOMENTS_TOL * scale, (err, scale)
    elif ref.dtype == torch.bfloat16:
        assert differ <= BF16_SHARE and err <= _bf16_ulp(scale), (differ, err, scale)
    else:
        assert err <= F32_TOL * scale, (err, scale)


def test_cases_are_the_probes():
    assert list(mosaic_dots.CASES) == list(_tpu_probe().CASES)
    assert set(mosaic_dots.CHAINS) == {k for k, c in mosaic_dots.CASES.items()
                                       if c.route == "dot_chain"}
    assert len(mosaic_dots.CHAINS) == 7 and set(mosaic_dots.CHAIN_FEEDS) == set(
        mosaic_dots.CHAINS)


@pytest.mark.parametrize("key", list(mosaic_dots.CASES))
def test_case_spec_matches_main(key):
    """The port's output shape, dtype and scratch (chosen by key) are what
    the TPU probe's main() chose (by substrings of the name), and its
    description is the probe's."""
    out_shape, scratch = _main_specs()[key]
    spec = mosaic_dots.CASES[key]
    assert spec.desc == _tpu_probe().CASES[key][0]
    assert spec.out_shape == tuple(out_shape.shape)
    assert str(spec.out_dtype)[6:] == str(out_shape.dtype)
    assert [(tuple(s), str(d)[6:]) for s, d in spec.scratch] == [
        (tuple(s.shape), str(s.dtype)) for s in scratch]


@pytest.mark.parametrize("key", list(mosaic_dots.CASES))
def test_case_matches_pallas(key):
    """Each case through the port's wrapper (its plain version on the CPU)
    against the Pallas kernel in interpret mode, on the same inputs."""
    ref = _pallas(key)
    out = mosaic_dots.run_case(key, _torch_inputs())
    assert out.shape == ref.shape and out.dtype == ref.dtype
    _held(key, out, ref)


# every orientation of a rank <= 3 contraction the probe uses, and ones it
# does not: a batch dim that is the minor one (neither k nor a free dim has
# unit stride: the staged feed), rank 1 and 2 operands, a transposed view,
# fab_mega's interior dot kx [32, 32] . a [l, 32, 64], and a depth of 200
# (the kernel's ring of four 32-deep stages wraps; the last stage is ragged)
_ORIENTATIONS = [(c.lhs, c.rhs, c.contract, c.batch) for c in mosaic_dots.CASES.values()
                 if c.route == "dot_general"] + [
    ("q", "q", ((1,), (1,)), ((2,), (2,))),
    ("u", "a3", ((0,), (0,)), ((1,), (1,))),
    ("k2", "k3", ((0,), (1,)), ((), ())),
    ("m", "k3t", ((1,), (1,)), ((), ())),
    ("v", "u", ((0,), (2,)), ((), ())),
    ("k3", "a_lhc", ((1,), (1,)), ((), ())),
    ("w", "z", ((1,), (0,)), ((), ())),
]


def _operands():
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    # a [32, 64] view with strides (1, 32)
    x["k3t"] = torch.from_numpy(_inputs()["u"][:, 0, :].copy()).t()
    x["v"] = x["k2"][0]
    x["a_lhc"] = x["u"].reshape(32, 32, 64)  # the interior dot's a [l, h, c]
    rng = np.random.default_rng(200)
    x["w"] = torch.from_numpy(rng.standard_normal((24, 200)).astype(np.float32))
    x["z"] = torch.from_numpy(rng.standard_normal((200, 40)).astype(np.float32))
    return x


@pytest.mark.parametrize("lhs, rhs, contract, batch", _ORIENTATIONS)
def test_layout_maps_dimension_numbers_to_strides(lhs, rhs, contract, batch):
    """The 14 numbers the kernel addresses its operands by (``layout``),
    read back through ``torch.as_strided`` and contracted, equal
    ``dot_general_plain``, and that equals the einsum written out by hand
    from the dimension numbers and ``jax.lax.dot_general`` in f32."""
    x = _operands()
    a, b = x[lhs], x[rhs]
    nb, m1, m2, n1, n2, k, *s = mosaic_dots.layout(a, b, contract, batch)
    av = torch.as_strided(a, (nb, m1, m2, k), s[:4], a.storage_offset())
    bv = torch.as_strided(b, (nb, n1, n2, k), s[4:], b.storage_offset())
    strided = torch.einsum("bxyk,bzwk->bxyzw", av.double(), bv.double())
    plain = mosaic_dots.dot_general_plain(a, b, contract, batch)
    want = np.asarray(_DOT_GENERAL(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                   (contract, batch), precision=jax.lax.Precision.HIGHEST))
    assert tuple(plain.shape) == want.shape
    np.testing.assert_allclose(strided.reshape(plain.shape).numpy(), plain.numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-4)
    eq = mosaic_dots._letters(a, b, contract, batch)
    assert torch.equal(plain, torch.einsum(eq, a.float(), b.float()))


@pytest.mark.parametrize("epilogue", ["sum_batch", "moments"])
def test_epilogues_plain(epilogue):
    """The epilogues' plain versions: the batch summed after the product,
    and the moments of the bf16-rounded product with its bf16 square."""
    x = _operands()
    if epilogue == "sum_batch":
        out = mosaic_dots.dot_general_plain(x["q"], x["q"], ((2,), (2,)), ((0,), (0,)),
                                            epilogue="sum_batch")
        full = torch.einsum("lci,ldi->lcd", x["q"], x["q"])
        assert out.shape == (64, 64) and torch.equal(out, full.sum(0))
    else:
        out = mosaic_dots.dot_general_plain(x["q"], x["m"], ((1,), (0,)), epilogue="moments")
        phi = torch.einsum("icl,co->ilo", x["q"], x["m"]).to(torch.bfloat16)
        assert out.shape == (2, 64)
        assert torch.equal(out[0], phi.float().sum((0, 1)))
        assert torch.equal(out[1], (phi * phi).float().sum((0, 1)))


class _Launched(Exception):
    pass


class _Library:
    """A stand-in for the kernel library: each limit says `limit`, a launch
    raises."""

    def __init__(self, limit):
        self.limit = limit

    def lns_dot_general_limit(self, *args):
        return self.limit

    def lns_dot_chain_limit(self, *args):
        return self.limit

    def lns_dot_general(self, *args):
        raise _Launched

    lns_dot_chain = lns_dot_general


@pytest.mark.parametrize("kernel", ["dot_general", "dot_chain"])
def test_wrappers_refuse_beyond_their_limit(kernel, monkeypatch):
    """With ``_build.is_card`` reporting a card, each wrapper raises naming
    the limit its C statement gives, before anything launches; with the
    limit met it goes on to the launch. Shapes outside what dot_general's
    layout can express, and a case that is not a chain, raise before the
    library is asked."""
    monkeypatch.setattr(_build, "is_card", lambda t, name: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: mock.Mock(cuda_stream=0))
    x = _torch_inputs()
    fn = getattr(mosaic_dots, kernel)
    call = {"dot_general": lambda: fn(x["u"], x["k2"], ((2,), (1,))),
            "dot_chain": lambda: fn("apply_chain", *x.values())}[kernel]
    key = f"mosaic_dots.{kernel}.launches"
    before = profiling.counters().get(key, 0)
    monkeypatch.setattr(_build, "library", lambda: _Library(b"C 64 (the probe's shape)"))
    with pytest.raises(ValueError, match=r"C 64 \(the probe's shape\)"):
        call()
    monkeypatch.setattr(_build, "library", lambda: _Library(None))
    with pytest.raises(_Launched):
        call()
    assert profiling.counters().get(key, 0) == before
    if kernel == "dot_general":
        for bad in (lambda: fn(torch.ones(2, 2, 2, 2), x["k2"], ((3,), (1,))),
                    lambda: fn(x["u"], x["u"], ((0, 1), (0, 1))),
                    lambda: fn(x["q"], x["q"], ((2,), (2,)), epilogue="sum_batch"),
                    lambda: fn(x["u"], x["m"], ((1,), (1,)))):
            with pytest.raises(ValueError, match="dot_general: "):
                bad()
    else:
        with pytest.raises(ValueError, match="dot_chain: a chain of"):
            fn("rhs_minor", *x.values())


def _tree(v):
    """A balanced tree of sums over dim 0 (a power of two), adjacent pairs
    first: ((v0 + v1) + (v2 + v3)) + ..."""
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def _chain_scr2_kernel_order(x):
    """``chain_scr2_f32`` with its statistics in the kernel's order
    (``csrc/mosaic_dots.cu``, ``chain_scr2``): the column sums of phi and
    phi^2 over the 1,024 rows (i, l) as 256 groups of 4 consecutive rows,
    each summed in row order (a thread's tile), then a balanced tree of
    adjacent pairs (its warp's 4 groups by shuffles, the 8 warps, the 8
    blocks); the products in f32 (their order is the plain version's)."""
    dg = mosaic_dots.dot_general_plain
    uf, k2f, k3f, wf = (x[k].float() for k in ("u", "k2", "k3", "m"))
    bb = dg(k3f, dg(uf, k2f, ((2,), (1,))), ((1,), (1,)))  # [I, C, L]
    phi = dg(bb, wf, ((1,), (0,))).reshape(-1, 4, wf.shape[1])  # [(i l) / 4, 4, D]
    s1, s2 = phi[:, 0], phi[:, 0] * phi[:, 0]
    for r in range(1, 4):
        s1, s2 = s1 + phi[:, r], s2 + phi[:, r] * phi[:, r]
    s1, s2 = _tree(s1), _tree(s2)
    n = 4 * phi.shape[0]
    mean = s1 / n
    inv = torch.rsqrt(torch.clamp(s2 / n - mean * mean, min=0.0) + 1e-5)
    mm = dg(wf * inv, wf, ((1,), (1,)))
    bias = dg((mean * inv)[None], wf, ((1,), (1,)))
    t = dg(bb, mm, ((1,), (0,)))
    return (t - bias[None]) + t


def test_chain_scr2_kernel_order():
    """chain 5's fixed-order statistics (the kernel's tree of sums, emulated
    in plain PyTorch) against the TPU body ``k_chain_scr2`` in interpret
    mode and against the plain version, at chain 5's tolerance on the card
    (``probe_dots.tolerance``: 1e-5 x max|ref|)."""
    rel, _ = probe_dots.tolerance("chain_scr2_f32")
    out = _chain_scr2_kernel_order(_torch_inputs())
    for ref in (_pallas("chain_scr2_f32"),
                mosaic_dots.dot_chain_plain("chain_scr2_f32", *_torch_inputs().values())):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        err = (out - ref).abs().max().item()
        assert err <= rel * ref.abs().max().item(), (err, ref.abs().max().item())


def _sum_batch_kernel_order(a, b, contract, cluster=8):
    """``dot_general``'s sum_batch in the kernel's order
    (``csrc/mosaic_dots.cu``, ``fold_tiles``): rank r of a cluster of
    min(8, batch) blocks sums its batches r, r + 8, ... in order (one
    accumulator each, the batches' products in f32), then each output is the
    ranks' sums added in rank order from 0. The order does not depend on the
    block tile."""
    full = mosaic_dots.dot_general_plain(a, b, contract, ((0,), (0,)))  # [batch, m, n]
    cl = min(cluster, full.shape[0])
    ranks = []
    for r in range(cl):
        acc = torch.zeros_like(full[0])
        for bi in range(r, full.shape[0], cl):
            acc = acc + full[bi]
        ranks.append(acc)
    out = torch.zeros_like(full[0])
    for acc in ranks:
        out = out + acc
    return out


def test_sum_batch_kernel_order():
    """gram_b+sum in the kernel's order of its f32 sums (emulated in plain
    PyTorch) against the TPU body in interpret mode and against the plain
    version, at 1e-5 x max|plain|."""
    x = _torch_inputs()
    out = _sum_batch_kernel_order(x["q"], x["q"], ((2,), (2,)))
    plain = mosaic_dots.run_case("gram_b+sum", x, plain=True)
    for ref in (_pallas("gram_b+sum"), plain):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * plain.abs().max().item(), (err, plain.abs().max().item())


def test_probe_dots_untimed_on_cpu():
    """The card probe's untimed run, as chip_smoke.py drives it, on the CPU
    (the wrappers take their plain versions): every case passes its check
    against itself, and the bound of each case comes from its shapes."""
    res = probe_dots.run(torch.device("cpu"), timed=False)
    assert list(res) == list(mosaic_dots.CASES) and all(r["ok"] for r in res.values())
    x = probe_dots.inputs(torch.device("cpu"))
    out = mosaic_dots.run_case("lhs_minor", x, plain=True)
    assert probe_dots.work("lhs_minor", x, out) == (2 * 64 * 32 * 32 * 32, 0, 264192)
    assert probe_dots.bound_ms(*probe_dots.work("chain_scr2_f32", x, out))[1] == "operations"


def test_probe_dots_exits_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["probe_dots"])
    with pytest.raises(SystemExit) as e:
        probe_dots.main()
    assert e.value.code == 1
