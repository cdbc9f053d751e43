"""Profiling and timing helpers (counterpart of ``lns_tpu.utils.profiling``).

- ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
  one, the CUDA card, writing a Chrome / Perfetto trace into `logdir`;
- ``Timer``: per-section wall time, a section stopped after the device
  finished the work that `sync_value` depends on;
- ``measure_host_rtt``: seconds for one trivial kernel and the fetch of
  its scalar;
- ``time_fn``: seconds per call of a carry-to-carry function, chained
  calls timed by CUDA events on the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from lns_tpu_torch.utils.debug import _leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU ops, and CUDA kernels where there is a card);
    on exit the trace is written into `logdir` as
    ``<host>_<pid>.<ms>.pt.trace.json`` (``tensorboard_trace_handler``),
    which ui.perfetto.dev, chrome://tracing and TensorBoard open. Yields the
    profiler, whose ``key_averages()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _tensors(tree):
    return (t for _, t in _leaves(tree) if isinstance(t, torch.Tensor))


def _wait_for(tree) -> None:
    """Wait for the current stream of every CUDA device that holds a tensor
    of `tree` (the work that wrote them was queued there)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


class Timer:
    """Accumulates per-section wall times; pass a section's device result
    as `sync_value` to ``stop`` when timing device work."""

    def __init__(self):
        self.totals = {}
        self._starts = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str, sync_value=None):
        """End section `name`, after the card's stream that computes
        `sync_value` (a tensor or a tree of them) has finished."""
        if sync_value is not None:
            _wait_for(sync_value)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - self._starts[name]

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s" for k, v in sorted(self.totals.items()))


def measure_host_rtt(reps: int = 5, device=None) -> float:
    """Seconds for one trivial kernel (``x + 1``) and the fetch of its
    scalar to the host, the mean of `reps` after a warm-up; on the card
    unless `device` names another (``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_host_rtt: no CUDA device; pass device=\"cpu\"")
    x = torch.zeros((), device=dev)
    (x + 1.0).item()
    t0 = time.perf_counter()
    for _ in range(reps):
        (x + 1.0).item()
    return (time.perf_counter() - t0) / reps


def time_fn(fn: Callable, carry, n: int = 10, rtt: Optional[float] = None) -> float:
    """Seconds per call of `fn` (carry -> carry of the same structure): one
    warm-up call, then `n` calls chained on the carry. With the carry on
    the card they are timed by CUDA events on the current stream, which
    measure device time from the first launch to the last kernel's end, so
    `rtt` (the JAX function subtracts the host's round trip from a host
    clock) is accepted for the same signature and not used; on the CPU by
    the host clock."""
    carry = fn(carry)
    on_card = any(t.is_cuda for t in _tensors(carry))
    if on_card:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            carry = fn(carry)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        carry = fn(carry)
    return (time.perf_counter() - t0) / n
