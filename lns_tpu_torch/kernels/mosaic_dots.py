"""The rank-3 dot orientations and FAB chains of the TPU probe, as two CUDA
C++ kernels for Hopper (``csrc/mosaic_dots.cu``).

Replaces ``benchmarks/probe_mosaic_dots.py`` (its ``pallas_call`` at :305,
over the nineteen bodies of its ``CASES``):

  * ``dot_general``: one strided contraction, the port's
    ``jax.lax.dot_general`` for operands of rank 3 or less with one
    contracting dim and at most one batch dim. JAX's dimension numbers, JAX's
    output order (batch, lhs free, rhs free), f32 sums rounded once to
    ``out_dtype``; the ``"sum_batch"`` epilogue sums the batch in the kernel,
    the ``"moments"`` epilogue reduces phi = bf16(product) to the [2, rhs
    free] f32 sums of phi and bf16(phi^2) over the lhs free dims. bf16 x bf16
    runs on tensor cores, a block tile of 32 or 64 by 32 or 64 chosen per
    launch (the rule is in C: ``tile_of``), every k stage of a block in a
    ring in shared memory; an f32 operand puts the product in full f32 on
    the CUDA cores. After a launch ``dot_general.feeds`` names how each
    operand reached the tensor cores (``FEEDS``) and ``dot_general.plan``
    gives the tile, the blocks and the cluster. 12 of the 19 cases, and
    ``fab_mega.interior_dot``.
  * ``dot_chain``: the seven chains, one launch of one cluster of 8 blocks
    each, every intermediate in shared memory (a block's own slice, and its
    peers' through distributed shared memory), rounding where the TPU body
    rounds.

The kernels take the probe's shapes (``dot_chain`` only those, stated in C:
``lns_dot_chain_limit``; ``dot_general`` any within ``lns_dot_general_limit``);
the plain versions take any. ``CASES`` holds each TPU case's description,
output shape and dtype, the scratch its Pallas kernel held in VMEM, and its
route here. Neither kernel is on a model's path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.utils import profiling

C, H, W, L, I = 64, 32, 32, 32, 32
# the TPU probe's inputs, all bf16
SHAPES = {"u": (C, H, W), "k2": (L, W), "k3": (I, H), "a3": (C, H, L), "q": (L, C, I),
          "m": (C, C)}
EPILOGUES = {None: 0, "sum_batch": 1, "moments": 2}
# how an operand reaches the tensor cores (the rule is in C: feed_of)
FEEDS = ("straight", "transposed", "staged", "f32 on CUDA cores")

bf16, f32 = torch.bfloat16, torch.float32


@dataclass(frozen=True)
class Case:
    """One TPU case: its description, output and VMEM scratch as the TPU
    probe's ``main()`` chose them, and the route here (``dot_general`` with
    its operands, dimension numbers and epilogue; else ``dot_chain``)."""

    desc: str
    out_shape: tuple
    out_dtype: torch.dtype
    scratch: tuple = ()  # ((shape, dtype), ...)
    lhs: str | None = None
    rhs: str | None = None
    contract: tuple = ()
    batch: tuple = ((), ())
    epilogue: str | None = None

    @property
    def route(self) -> str:
        return "dot_chain" if self.lhs is None else "dot_general"


# The output dtype and scratch are chosen by key here (the TPU probe picks
# them by substrings of a name it rebinds to include the description).
CASES = {
    "rhs_minor": Case("[L,W].[C,H,W]->[L,C,H]", (L, C, H), bf16, (), "k2", "u", ((1,), (2,))),
    "lhs_minor": Case("[C,H,W].[L,W]->[C,H,L]", (C, H, L), bf16, (), "u", "k2", ((2,), (1,))),
    "lhs_interior": Case("[C,H,L].[I,H]->[C,L,I]", (C, L, I), bf16, (), "a3", "k3",
                         ((1,), (1,))),
    "rhs_interior": Case("[I,H].[C,H,L]->[I,C,L]", (I, C, L), bf16, (), "k3", "a3",
                         ((1,), (1,))),
    "gram_batched": Case("[L,C,I]x2 ->[L,C,C]", (L, C, C), f32, (), "q", "q", ((2,), (2,)),
                         ((0,), (0,))),
    "gram_b+sum": Case("[L,C,I]x2 ->[C,C]", (C, C), f32, (), "q", "q", ((2,), (2,)),
                       ((0,), (0,)), "sum_batch"),
    "phi_interior": Case("[I,C,L].[C,O]->[I,L,O]", (I, L, C), bf16, (), "q", "m", ((1,), (0,))),
    "phi_moments": Case("[I,C,L].[C,O]->[2,O]", (2, C), f32, (), "q", "m", ((1,), (0,)),
                        epilogue="moments"),
    "phi_f32out": Case("[I,C,L].[C,O]->[I,L,O]f32", (I, L, C), f32, (), "q", "m", ((1,), (0,))),
    "apply_chain": Case("S1+S2+proj+acc->[I,L,O]", (I, L, C), bf16, (((I, L, C), f32),)),
    "projfirst": Case("[C,O].[C,H,W]->[O,H,W]", (C, H, W), bf16, (), "m", "u", ((0,), (0,))),
    "chain_projf_f32": Case("proj0+S1+S2+acc->[I,O,L]f32", (I, C, L), f32,
                            (((I, C, L), f32),)),
    "chain_moments_f32": Case("proj0+S1+S2->[O,2]f32", (C, 2), f32),
    "proj_major": Case("[C,H,L].[C,O]->[H,L,O]", (H, L, C), bf16, (), "a3", "m", ((0,), (0,))),
    "scr_bf16_f32": Case("S1+S2->bf16 scr->proj f32", (I, L, C), f32, (((I, C, L), bf16),)),
    "scr_f32_f32": Case("S1+S2->f32 scr->proj f32", (I, L, C), f32, (((I, C, L), f32),)),
    "chain_scr2_f32": Case("full FAB chain, scr handoffs", (I, L, C), f32,
                           (((I, L, C), f32), ((C, H, L), f32), ((I, C, L), f32))),
    # its scratch copy of q is the identity here: every operand comes from
    # shared memory on the card
    "scrlhsint_f32": Case("scratch-ref lhs-interior dot", (I, L, C), f32, (((I, C, L), bf16),),
                          "q", "m", ((1,), (0,))),
    "transp_chain_f32": Case("refint+transp-store+scrint", (I, C, L), f32,
                             (((L, I, C), f32), ((I, L, C), f32))),
}
# dot_chain's chain numbers (csrc/mosaic_dots.cu: enum Chain)
CHAINS = ("apply_chain", "chain_projf_f32", "chain_moments_f32", "scr_bf16_f32", "scr_f32_f32",
          "chain_scr2_f32", "transp_chain_f32")
# how each chain's stages take their operands from shared memory (the
# kernel's design, csrc/mosaic_dots.cu): lhs x rhs feed per stage, and which
# operand comes from the peers' shared memory (DSMEM)
CHAIN_FEEDS = {
    "apply_chain": "a=u.k2 straight x straight; bb=k3.a straight x transposed; "
                   "t=bb.m transposed (bb by DSMEM) x transposed",
    "chain_projf_f32": "v=m.u transposed x transposed; a=v.k2 straight x straight; "
                       "t=k3.a straight x transposed (a by DSMEM)",
    "chain_moments_f32": "v=m.u transposed x transposed; a=v.k2 straight x straight; "
                         "phi=k3.a straight x transposed (a by DSMEM)",
    "scr_bf16_f32": "a=u.k2 straight x straight; bb=k3.a straight x transposed; "
                    "t=bb.m transposed (bb by DSMEM) x transposed",
    "scr_f32_f32": "a=u.k2 straight x straight; bb=k3.a straight x transposed; "
                   "t=bb.m f32 on CUDA cores (bb by DSMEM)",
    "chain_scr2_f32": "every stage f32 on CUDA cores (bb and the column sums by DSMEM)",
    "transp_chain_f32": "a=q.m transposed x transposed, stored swapped; "
                        "bb=a'.k2 f32 on CUDA cores (a' by DSMEM)",
}


def _dims(a, b, contract, batch):
    """(ca, cb, ba, bb): the contracting and batch dims (batch None for
    none); raises on what dot_general does not take."""
    if a.dim() > 3 or b.dim() > 3 or a.dim() < 1 or b.dim() < 1:
        raise ValueError(f"dot_general: operands of rank 1 to 3, got {a.dim()} and {b.dim()}")
    (ca, cb), (ba, bb) = contract, batch
    if len(ca) != 1 or len(cb) != 1:
        raise ValueError(f"dot_general: one contracting dim, got {contract}")
    if len(ba) != len(bb) or len(ba) > 1:
        raise ValueError(f"dot_general: at most one batch dim, got {batch}")
    ca, cb = ca[0], cb[0]
    ba, bb = (ba[0], bb[0]) if ba else (None, None)
    if not (0 <= ca < a.dim() and 0 <= cb < b.dim()) or ca == ba or cb == bb:
        raise ValueError(f"dot_general: bad dimension numbers {contract}, {batch}")
    if ba is not None and not (0 <= ba < a.dim() and 0 <= bb < b.dim()):
        raise ValueError(f"dot_general: bad batch dims {batch}")
    if a.shape[ca] != b.shape[cb] or (ba is not None and a.shape[ba] != b.shape[bb]):
        raise ValueError(f"dot_general: sizes differ, {tuple(a.shape)} and {tuple(b.shape)} "
                         f"at {contract}, {batch}")
    return ca, cb, ba, bb


def _out_shape(a, b, contract, batch, epilogue):
    ca, cb, ba, bb = _dims(a, b, contract, batch)
    fa = [a.shape[d] for d in range(a.dim()) if d not in (ca, ba)]
    fb = [b.shape[d] for d in range(b.dim()) if d not in (cb, bb)]
    if epilogue not in EPILOGUES:
        raise ValueError(f"dot_general: epilogue one of {list(EPILOGUES)}, got {epilogue!r}")
    if epilogue == "sum_batch" and ba is None:
        raise ValueError("dot_general: the sum_batch epilogue needs a batch dim")
    if epilogue == "moments":
        if ba is not None:
            raise ValueError("dot_general: the moments epilogue takes no batch dim")
        return (2, *fb)
    bsz = [] if ba is None or epilogue == "sum_batch" else [a.shape[ba]]
    return (*bsz, *fa, *fb)


def layout(a, b, contract, batch=((), ())):
    """The 14 numbers the kernel addresses its operands by: nb, m1, m2, n1,
    n2, k, then a's element strides (batch, m1, m2, k) and b's (batch, n1,
    n2, k). A side's free dims are (r1, r2) in JAX's order, padded in front
    with size 1; a dim of size 1 (or none) gets stride 0. Element (batch,
    m1 m2 + i, k) of a is at a.data_ptr() + its dot with the strides."""
    ca, cb, ba, bb = _dims(a, b, contract, batch)

    def side(t, c, bt):
        free = [d for d in range(t.dim()) if d not in (c, bt)]
        sizes = [t.shape[d] for d in free]
        strides = [t.stride(d) if t.shape[d] > 1 else 0 for d in free]
        while len(sizes) < 2:
            sizes.insert(0, 1)
            strides.insert(0, 0)
        sb = t.stride(bt) if bt is not None and t.shape[bt] > 1 else 0
        return sizes, [sb, *strides, t.stride(c)]

    (m1, m2), sa = side(a, ca, ba)
    (n1, n2), sb = side(b, cb, bb)
    nb = a.shape[ba] if ba is not None else 1
    return [nb, m1, m2, n1, n2, a.shape[ca], *sa, *sb]


def _letters(a, b, contract, batch):
    """The einsum equation of the same contraction (k contracted, n batch)."""
    ca, cb, ba, bb = _dims(a, b, contract, batch)
    la, lb = list("abc"[:a.dim()]), list("def"[:b.dim()])
    la[ca] = lb[cb] = "k"
    if ba is not None:
        la[ba] = lb[bb] = "n"
    out = (["n"] if ba is not None else []) + [x for x in la if x not in "kn"] + \
        [x for x in lb if x not in "kn"]
    return f"{''.join(la)},{''.join(lb)}->{''.join(out)}"


def dot_general_plain(a, b, contract, batch=((), ()), out_dtype=f32, epilogue=None):
    """Plain PyTorch version of ``dot_general``: a ``torch.einsum`` from the
    same dimension numbers, operands widened to f32 (exact for bf16), sums in
    f32, one rounding at the end; both epilogues."""
    out_shape = _out_shape(a, b, contract, batch, epilogue)
    t = torch.einsum(_letters(a, b, contract, batch), a.float(), b.float())
    if epilogue == "sum_batch":
        t = t.sum(0)
    elif epilogue == "moments":
        phi = t.to(bf16)
        lhs_free = tuple(range(t.dim() - (len(out_shape) - 1)))
        t = torch.stack([phi.float().sum(lhs_free), (phi * phi).float().sum(lhs_free)])
    return t.to(out_dtype)


def _code(t):
    return _build.DTYPE_CODE.get(t.dtype, -1)


def dot_general(a, b, contract, batch=((), ()), out_dtype=f32, epilogue=None):
    """``jax.lax.dot_general(a, b, (contract, batch))`` with f32 sums, rounded
    once to `out_dtype` (bf16 or f32), or with an epilogue (``"sum_batch"``,
    ``"moments"``). Operands of rank <= 3, one contracting dim, at most one
    batch dim, any strides. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises."""
    t0 = profiling.clock()
    if not _build.on_cuda(a, "dot_general", b):
        return dot_general_plain(a, b, contract, batch, out_dtype, epilogue)
    if b.device != a.device:
        raise ValueError(f"dot_general: operands on {a.device} and {b.device}")
    out_shape = _out_shape(a, b, contract, batch, epilogue)
    lay = (ctypes.c_longlong * 14)(*layout(a, b, contract, batch))
    out_code = _build.DTYPE_CODE.get(out_dtype, -1)
    lib = _build.library()
    msg = lib.lns_dot_general_limit(lay, _code(a), _code(b), out_code, EPILOGUES[epilogue])
    if msg:
        raise ValueError(f"dot_general: {str(a.dtype)[6:]} x {str(b.dtype)[6:]} -> "
                         f"{str(out_dtype)[6:]} at {list(lay)} needs {msg.decode()}")
    out = torch.empty(out_shape, device=a.device, dtype=out_dtype)
    feeds, plan = (ctypes.c_int * 2)(), (ctypes.c_int * 4)()
    rc = lib.lns_dot_general(lay, _code(a), _code(b), out_code, EPILOGUES[epilogue],
                             a.data_ptr(), b.data_ptr(), out.data_ptr(), feeds, plan,
                             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "dot_general (lns_dot_general)")
    dot_general.feeds = (FEEDS[feeds[0]], FEEDS[feeds[1]])
    dot_general.plan = {"tile": f"{plan[0]}x{plan[1]}", "blocks": plan[2], "cluster": plan[3]}
    profiling.launched("mosaic_dots.dot_general", 0, t0)
    return out


dot_general.feeds = None
dot_general.plan = None  # {"tile": "rows x columns", "blocks": n, "cluster": n} of the last launch


def dot_chain_plain(case, u, k2, k3, a3, q, m):
    """Plain PyTorch version of ``dot_chain``: the TPU body's stages as
    ``dot_general_plain`` calls, with its casts."""
    dg = dot_general_plain
    if case == "apply_chain":
        a = dg(u, k2, ((2,), (1,)), out_dtype=bf16)
        bb = dg(k3, a, ((1,), (1,)), out_dtype=bf16)
        t = dg(bb, m, ((1,), (0,)))
        return (t + t).to(bf16)
    if case in ("chain_projf_f32", "chain_moments_f32"):
        v = dg(m, u, ((0,), (0,)), out_dtype=bf16)
        a = dg(v, k2, ((2,), (1,)), out_dtype=bf16)
        if case == "chain_projf_f32":
            t = dg(k3, a, ((1,), (1,)))
            return t + t
        phi = dg(k3, a, ((1,), (1,)), out_dtype=bf16)  # [I, O, L]
        return torch.stack([phi.float().sum((0, 2)), (phi * phi).float().sum((0, 2))], 1)
    if case in ("scr_bf16_f32", "scr_f32_f32"):
        a = dg(u, k2, ((2,), (1,)), out_dtype=bf16)
        bb = dg(k3, a, ((1,), (1,)), out_dtype=bf16 if case == "scr_bf16_f32" else f32)
        return dg(bb, m if case == "scr_bf16_f32" else m.float(), ((1,), (0,)))
    if case == "chain_scr2_f32":
        uf, k2f, k3f, wf = u.float(), k2.float(), k3.float(), m.float()
        a = dg(uf, k2f, ((2,), (1,)))
        bb = dg(k3f, a, ((1,), (1,)))
        phi = dg(bb, wf, ((1,), (0,)))  # [I, L, D]
        n = phi.shape[0] * phi.shape[1]
        mean = phi.sum((0, 1)) / n
        var = torch.clamp(((phi * phi).sum((0, 1)) / n) - mean * mean, min=0.0)
        inv = torch.rsqrt(var + 1e-5)
        mm = dg(wf * inv, wf, ((1,), (1,)))
        bias = dg((mean * inv)[None], wf, ((1,), (1,)))  # [1, C]
        t = dg(bb, mm, ((1,), (0,)))
        return (t - bias[None]) + t
    if case == "transp_chain_f32":
        a = dg(q, m, ((1,), (0,)))  # [32, 32, 64]
        return dg(a.transpose(0, 1), k2, ((1,), (1,)))
    raise ValueError(f"dot_chain: a chain of {CHAINS}, got {case!r}")


def dot_chain(case, u, k2, k3, a3, q, m):
    """The TPU probe's chain `case` (one of ``CHAINS``) on its inputs (bf16,
    the probe's shapes; a3 is read by no chain), in one launch of one
    cluster of 8 blocks whose intermediates stay in shared memory. Returns
    the case's output (``CASES[case]``). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream or
    raises."""
    if case not in CHAINS:
        raise ValueError(f"dot_chain: a chain of {CHAINS}, got {case!r}")
    t0 = profiling.clock()
    if not _build.on_cuda(u, "dot_chain", k2, k3, a3, q, m):
        return dot_chain_plain(case, u, k2, k3, a3, q, m)
    args = {"u": u, "k2": k2, "k3": k3, "a3": a3, "q": q, "m": m}
    if u.dim() != 3 or k2.dim() != 2 or k3.dim() != 2:
        raise ValueError("dot_chain: u must be [C, H, W], k2 [L, W] and k3 [I, H]")
    c, h, w = u.shape
    lib = _build.library()
    code = _code(u) if all(t.dtype == u.dtype for t in args.values()) else -1
    msg = lib.lns_dot_chain_limit(CHAINS.index(case), code, c, h, w, k2.shape[0], k3.shape[0])
    if msg:
        raise ValueError(f"dot_chain: {case} {str(u.dtype)[6:]} at u {list(u.shape)} needs "
                         f"{msg.decode()}")
    _build.check_shapes("dot_chain", u.device, {k: (t, SHAPES[k]) for k, t in args.items()})
    given = u, k2, k3, q, m
    u, k2, k3, q, m = (_build.ready(t, u.dtype) for t in given)
    spec = CASES[case]
    out = torch.empty(spec.out_shape, device=u.device, dtype=spec.out_dtype)
    rc = lib.lns_dot_chain(CHAINS.index(case), u.data_ptr(), k2.data_ptr(), k3.data_ptr(),
                           q.data_ptr(), m.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(rc, f"dot_chain {case} (lns_dot_chain)")
    profiling.launched("mosaic_dots.dot_chain", _build.copy_bytes(*zip(given, (u, k2, k3, q, m))),
                       t0)
    return out


def run_case(key, x: dict, plain: bool = False):
    """TPU case `key` on the inputs `x` (by name): the kernels, or with
    `plain` their plain versions."""
    spec = CASES[key]
    if spec.route == "dot_chain":
        fn = dot_chain_plain if plain else dot_chain
        return fn(key, *(x[k] for k in SHAPES))
    fn = dot_general_plain if plain else dot_general
    return fn(x[spec.lhs], x[spec.rhs], spec.contract, spec.batch, spec.out_dtype, spec.epilogue)
