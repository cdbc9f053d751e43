"""Build and load the CUDA kernels in ``lns_tpu_torch/csrc``.

nvcc compiles every ``csrc/*.cu`` (one nvcc process per source, all started
together) and links the objects into one shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``), which ``ctypes``
loads. The library lands in ``lns_tpu_torch/_build/`` (git-ignored) under a
name keyed by a hash of the sources and flags, so a checkout builds it at
first use and reuses it after. A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lns_axial_apply": [_I] * 3 + [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P],
    "lns_blocked_copy": [_P] * 2 + [_I] * 3 + [ctypes.c_longlong, ctypes.POINTER(_I), _P],
    "lns_bmm": [_I] + [_P] * 3 + [_I] * 3 + [_P],
    "lns_dot_chain": [_I] + [_P] * 7,
    "lns_dot_general": [_P] + [_I] * 4 + [_P] * 6,
    "lns_fab_core": [_I] + [_P] * 15 + [_I] * 7 + [ctypes.c_float, _P],
    "lns_fab_mega_apply": [_P] * 6 + [_I] * 2 + [_P],
    "lns_fab_mega_stats": [_P] * 5 + [_I] * 2 + [_P],
    "lns_group_norm": [_I] + [_P] * 6 + [_I] * 4 + [ctypes.c_float, _I, _P],
    "lns_prop_rollout": [_I] + [_P] * 14 + [_I] * 11 + [_P],
    "lns_prop_rollout_film": [_P] * 15 + [_I] * 6 + [_P],
    "lns_transpose_hw": [_I] + [_P] * 2 + [_I] * 4 + [_P],
}

_lib = None

# the C entry points' dtype argument: which T (float, __nv_bfloat16) to run
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def is_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor, True for a CUDA tensor; any other device
    raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def on_cuda(t: torch.Tensor, name: str, *inputs) -> bool:
    """False for a CPU tensor (the wrapper takes its plain version), True
    for a CUDA tensor (it launches the kernel); any other device raises.

    A launch's output has no ``grad_fn``. Three wrappers carry a gradient
    by launching inside an autograd Function whose backward is the plain
    version's (the Function's forward runs without grad, so it passes
    here): kernel 2 ``fab_fused_core``, kernel 3 ``fused_group_norm_swish``
    and kernel 4 ``fab_axial_in_fused`` in the d-space core's mode. Every
    other launch (kernels 1, 5, 6, 7, and kernel 4 in its other modes)
    raises here for a CUDA tensor with grad mode on and `t` or one of the
    wrapper's other tensor `inputs` requiring grad, before anything
    launches: a backward through it would silently drop the gradient of
    everything upstream."""
    if not is_card(t, name):
        return False
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in (t, *inputs)):
        raise RuntimeError(f"{name}: the kernel has no gradient, and an input requires grad; "
                           "call it under torch.no_grad() or on tensors that do not require "
                           "grad (the kernels with a gradient: fab_fused_core, "
                           "fused_group_norm_swish, and fab_axial_in_fused with the norm off, "
                           "stats=True and heads_last=True)")
    return True


def ready(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t contiguous in `dtype`, from a 16-byte boundary (the kernels that
    take it load 16-byte pieces)."""
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def copy_bytes(*pairs) -> int:
    """Bytes of the copies of its arguments a wrapper hands its kernel: of
    each (given, used) pair, used's when it is another tensor than given (a
    cast, ``contiguous``, ``ready`` or an alignment clone, each of which
    returns its argument when it has nothing to do)."""
    return sum(used.nbytes for given, used in pairs if used is not given)


def check_shapes(name: str, dev, expect: dict) -> None:
    """Raise unless each tensor of `expect` ({arg: (tensor, shape)}) has its
    shape and lies on `dev`."""
    for arg, (t, shape) in expect.items():
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name}: {arg} must be {tuple(shape)} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): the one beside nvcc
    on PATH, else under /usr/local/cuda/bin; raises if there is none."""
    found = shutil.which("nvcc")
    bindir = Path(found).parent if found else Path("/usr/local/cuda/bin")
    tool = bindir / name
    if not tool.exists():
        raise RuntimeError(f"{name} not found in {bindir}: the CUDA kernels need the CUDA toolkit")
    return str(tool)


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")), sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblns_kernels_{h.hexdigest()[:16]}.so"


def build(ptxas_verbose: bool = False) -> str:
    """Compile the library if it is not built yet; returns nvcc's messages
    (with ``ptxas_verbose``, each kernel's registers, shared memory and
    spills), or '' when the library was already there."""
    out = library_path()
    if out.exists() and not ptxas_verbose:
        return ""
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{tag}.tmp.so")
    nvcc, verbose = cuda_tool(), (["-Xptxas", "-v"] if ptxas_verbose else [])
    steps = [[[nvcc, *NVCC_FLAGS, *verbose, "-c", "-o", str(o), str(src)]
              for src, o in zip(sources, objs)],
             [[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]]]
    msgs = []
    try:
        for cmds in steps:  # the compiles run side by side, then the link
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            texts = [proc.communicate()[0] for proc in procs]  # wait for every one
            for cmd, proc, text in zip(cmds, procs, texts):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                       f"{text}")
            msgs += texts
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    return "".join(msgs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lns_error_string.argtypes = [ctypes.c_int]
        lib.lns_error_string.restype = ctypes.c_char_p
        lib.lns_axial_limit.argtypes = [ctypes.c_int] * 4
        lib.lns_axial_limit.restype = ctypes.c_char_p
        lib.lns_blocked_copy_limit.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong]
        lib.lns_blocked_copy_limit.restype = ctypes.c_char_p
        lib.lns_dot_chain_limit.argtypes = [ctypes.c_int] * 7
        lib.lns_dot_chain_limit.restype = ctypes.c_char_p
        lib.lns_dot_general_limit.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
        lib.lns_dot_general_limit.restype = ctypes.c_char_p
        for name in ("lns_fab_mega_limit", "lns_interior_dot_limit"):
            getattr(lib, name).argtypes = [ctypes.c_int] * 5
            getattr(lib, name).restype = ctypes.c_char_p
        lib.lns_axial_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.lns_axial_plan.restype = ctypes.c_int
        lib.lns_fab_core_bf16_limit.argtypes = [ctypes.c_int] * 5
        lib.lns_fab_core_bf16_limit.restype = ctypes.c_char_p
        lib.lns_fab_core_bf16_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.lns_fab_core_bf16_plan.restype = ctypes.c_int
        lib.lns_group_norm_limit.argtypes = [ctypes.c_int] * 5
        lib.lns_group_norm_limit.restype = ctypes.c_char_p
        lib.lns_group_norm_workspace.argtypes = [ctypes.c_int] * 5
        lib.lns_group_norm_workspace.restype = ctypes.c_longlong
        lib.lns_group_norm_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.lns_group_norm_plan.restype = ctypes.c_int
        lib.lns_prop_rollout_limit.argtypes = [ctypes.c_int] * 7
        lib.lns_prop_rollout_limit.restype = ctypes.c_char_p
        lib.lns_prop_rollout_workspace.argtypes = [ctypes.c_int] * 6
        lib.lns_prop_rollout_workspace.restype = ctypes.c_longlong
        lib.lns_prop_rollout_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.lns_prop_rollout_plan.restype = ctypes.c_int
        lib.lns_prop_rollout_film_limit.argtypes = [ctypes.c_int] * 6
        lib.lns_prop_rollout_film_limit.restype = ctypes.c_char_p
        lib.lns_prop_rollout_film_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.lns_prop_rollout_film_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().lns_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
