"""A blocked copy, CUDA C++ for Hopper (``csrc/blocked_copy.cu``).

Replaces ``benchmarks/probe_pallas_bw.py: pallas_copy`` (``_copy_kernel``):
x [B, G, ...] is copied with one thread block per ``samples_per_block``
samples of one group, as the TPU probe copies a (s, 1, M, N) block per grid
step. The output is x, bitwise, in any dtype. Bound by bytes (one read and
one write). Rows whose size and pointers are multiples of 16 bytes take
the bulk route (one thread streams the block's rows through shared memory
by TMA bulk copies, no byte in registers); any other row the per-thread
route (16-byte or smaller pieces, several in flight per thread). The rule
and the copy's limits are stated once, in C (``bulk_route``,
``lns_blocked_copy_limit``); the launch reports the route it took.

On row-major memory a reshape that keeps the element order (the lane-merge
and lane-split reshapes of ``benchmarks/probe_mosaic.py``, the collapse and
split forms of ``probe_fab_mega.py``'s pieces) is this copy followed by a
view: the copy is all the work.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.utils import profiling

ROUTES = ("threads", "bulk")  # the C rule's codes 0 and 1


def blocked_copy_plain(x, samples_per_block: int = 1):
    """Plain PyTorch version of ``blocked_copy``: a contiguous copy (the
    blocking changes no value)."""
    return x.clone(memory_format=torch.contiguous_format)


def blocked_copy(x, samples_per_block: int = 1):
    """x [B, G, ...] -> a contiguous copy of x, one block per
    ``samples_per_block`` samples of one group. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream, on
    the route the C rule picks, or raises. ``blocked_copy.route`` is the
    route of the last call: "bulk" or "threads" as C reports it, or
    "plain"."""
    t0 = profiling.clock()
    if not _build.on_cuda(x, "blocked_copy"):
        blocked_copy.route = "plain"
        return blocked_copy_plain(x, samples_per_block)
    if x.dim() < 2:
        raise ValueError("blocked_copy: x must be [B, G, ...]")
    b, g = x.shape[:2]
    row = math.prod(x.shape[2:]) * x.element_size()
    limit = _build.library().lns_blocked_copy_limit(b, g, samples_per_block, row)
    if limit:
        raise ValueError(f"blocked_copy: [{b}, {g}, {row} bytes] with {samples_per_block} "
                         f"samples per block needs {limit.decode()}")
    given, x = x, x.contiguous()
    out = torch.empty_like(x)
    route = ctypes.c_int(-1)
    rc = _build.library().lns_blocked_copy(x.data_ptr(), out.data_ptr(), b, g, samples_per_block,
                                           row, ctypes.byref(route),
                                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "blocked_copy (lns_blocked_copy)")
    blocked_copy.route = ROUTES[route.value]
    profiling.launched("blocked_copy.blocked_copy", _build.copy_bytes((given, x)), t0)
    return out


blocked_copy.route = None
