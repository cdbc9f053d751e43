"""Profiling and timing helpers (counterpart of ``lns_tpu.utils.profiling``),
and the program's own spans and counters.

- ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
  one, the CUDA card, writing a Chrome / Perfetto trace into `logdir`;
- ``Timer``: per-section wall time, a section stopped after the device
  finished the work that `sync_value` depends on;
- ``time_fn``: seconds per call of a carry-to-carry function, chained
  calls timed by CUDA events on the card;
- ``span(name, **attrs)``: a phase of the program (``LatentDynamics.
  predict`` opens one at each layer boundary). Off unless a
  ``torch.profiler`` is active or the block runs inside ``recording()``;
  off, it costs one check. On, it stamps its start and end with
  ``time.time_ns()``, the clock of the profiler's events, appends a
  ``Span`` record to a bounded buffer (``spans()``, ``reset()``,
  ``dropped()``), and under a profiler also opens
  ``torch.profiler.record_function(name)``, so that the phase lands in the
  same trace as the device's kernels; ``annotate(**attrs)`` adds attrs to
  the innermost open span (kernel 1's wrapper names its plan there);
- ``count(key, n)``, ``counters()``: one registry of integer counters,
  always on. Each kernel wrapper counts, per launch, under
  ``<module>.<wrapper>``: ``.launches``, ``.scratch_bytes`` (what it
  allocates besides its output and hands the kernel) and, while spans are
  on, ``.host_ns`` (its own host time from entry to return): ``clock()``
  at its entry, ``launched()`` after the launch. A root span (``root=True``,
  ``lns.predict``) carries every counter's change over its extent in its
  attrs, under ``"counters"``.

Spans and counters are kept for the whole process; a span's parent and
predict are those of the thread that opened it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

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


# -- spans and counters ---------------------------------------------------------

LIMIT = 1 << 16  # span records kept; the oldest go first


class Span(NamedTuple):
    """One closed span: its `name`, its own `id`, the `predict` (the id of
    the root span it lies in, None outside any), the id of its `parent`
    span (None at the top), `nth` (how many spans of its name its predict
    opened before it: a decode span's chunk index), its start and end in
    ``time.time_ns()`` and its attrs."""
    name: str
    id: int
    predict: Optional[int]
    parent: Optional[int]
    nth: int
    start_ns: int
    end_ns: int
    attrs: dict


_records: "collections.deque[Span]" = collections.deque(maxlen=LIMIT)
_dropped = 0
_recording = 0
_ids = itertools.count(1)
_local = threading.local()  # the open spans of this thread
_counts: Dict[str, int] = {}
_keys: Dict[str, tuple] = {}  # wrapper -> its three counter keys
_lock = threading.Lock()


def on() -> bool:
    """Whether spans record: a ``torch.profiler`` is active, or a
    ``recording()`` block is open."""
    return bool(_recording) or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """Spans record inside this block with no profiler (for an operator's
    run or a test); no profiler range is opened for them."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class _Off:
    """What ``span`` returns while spans are off: a context that does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span while it is open."""

    def __init__(self, name: str, root: bool, attrs: dict):
        self.name, self.root, self.attrs = name, root, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        if self.root:
            self.predict, self.seen = self.id, {}
        else:
            self.predict = outer.predict if outer else None
            self.seen = outer.seen if outer else {}
        self.nth = self.seen.get(self.name, 0)
        self.seen[self.name] = self.nth + 1
        self.parent = outer.id if outer else None
        self.before = counters() if self.root else None
        stack.append(self)
        self.start = time.time_ns()
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        if self.before is not None:
            now = counters()
            self.attrs["counters"] = {k: v - self.before.get(k, 0) for k, v in now.items()
                                      if v != self.before.get(k, 0)}
        global _dropped
        with _lock:
            _dropped += len(_records) == _records.maxlen
            _records.append(Span(self.name, self.id, self.predict, self.parent, self.nth,
                                 self.start, end, self.attrs))
        return False


def span(name: str, root: bool = False, **attrs):
    """A context over a phase of the program, recorded while ``on()``.
    `root` starts a predict: the spans inside it share its id, and it
    carries every counter's change over its extent."""
    if not (_recording or torch.autograd._profiler_enabled()):
        return _OFF
    return _Open(name, root, attrs)


def annotate(**attrs) -> None:
    """Add `attrs` to the innermost span this thread has open (a wrapper's
    account of how it ran, as kernel 1's plan on ``lns.rollout``); nothing
    while spans are off or none is open."""
    if not (_recording or torch.autograd._profiler_enabled()):
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].attrs.update(attrs)


def spans() -> List[Span]:
    """The recorded spans, oldest first (a span is appended when it closes,
    so children come before their parents)."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Records dropped from the full buffer since the last ``reset()``."""
    return _dropped


def reset() -> None:
    """Clear the span records and the count of dropped ones."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def count(key: str, n: int = 1) -> None:
    """Add `n` to counter `key`."""
    with _lock:
        _counts[key] = _counts.get(key, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def clock() -> int:
    """A wrapper's entry stamp for ``launched``: ``time.perf_counter_ns()``
    while spans are on, else 0 (its host time is then not counted)."""
    return time.perf_counter_ns() if on() else 0


def launched(wrapper: str, scratch_bytes: int = 0, t0: int = 0) -> None:
    """Count one launch of the kernel wrapper `wrapper`
    (``<module>.<function>``): its ``.launches``, the ``.scratch_bytes`` it
    allocated besides its output, and, with `t0` from ``clock()`` at its
    entry, its ``.host_ns`` up to now."""
    keys = _keys.get(wrapper)
    if keys is None:
        keys = _keys[wrapper] = tuple(f"{wrapper}.{k}" for k in ("launches", "scratch_bytes",
                                                                 "host_ns"))
    dt = time.perf_counter_ns() - t0 if t0 else 0
    with _lock:
        c = _counts
        c[keys[0]] = c.get(keys[0], 0) + 1
        c[keys[1]] = c.get(keys[1], 0) + scratch_bytes
        if dt:
            c[keys[2]] = c.get(keys[2], 0) + dt
