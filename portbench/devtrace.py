"""The reduction of a ``torch.profiler`` trace of a traced window: the
device's busy time, each kernel's device time by name, the device time of
the operations launched inside each of the harness's ``encode`` and
``decode`` ranges (a device operation is tied to the host call that launched
it by the profiler's correlation id), the device operations that took the
most time and the longest idle gaps, each named by what the host was doing
then (the harness's range and the innermost host operation open at the gap's
middle)."""

from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

TOP = 10  # entries of each breakdown list
SPANS = ("predict", "sync", "encode", "decode")  # the harness's ranges around its calls
LAYER_SPANS = ("encode", "decode")  # ranges whose launched device time is summed


@dataclass
class Trace:
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]   # device op name -> (seconds, calls)
    span_s: Dict[str, float]                # range -> device seconds of the ops launched in it
    device_ops: List[list]
    idle_gaps: List[list]

    def device_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the ops whose name holds one of `patterns`."""
        return sum(s for name, (s, _) in self.kernels.items() if any(p in name for p in patterns))


def _raw_events(prof):
    """(device events, host events) as (start_ns, end_ns, name), from the
    profiler's own records (no event tree is built), and the launch time of
    each correlation id (the host's CUDA runtime call that carries it)."""
    from torch.autograd import DeviceType

    dev, host, launched = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        row = (start, start + dur, e.name())
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
            if e.name().startswith("cu"):  # a runtime or driver call: a launch, copy or set
                launched[e.correlation_id()] = start
        elif not (e.is_user_annotation() if hasattr(e, "is_user_annotation") else e.name() in SPANS):
            dev.append(row + (e.correlation_id(),))  # a range's shadow on the device is no operation
    return dev, host, launched


def _span_seconds(dev, host, launched) -> Dict[str, float]:
    """Per range of ``LAYER_SPANS``: the device seconds of the operations
    whose launch lies inside one of its occurrences on the host."""
    out = {}
    for span in LAYER_SPANS:
        ranges = sorted((s, e) for s, e, name in host if name == span)
        starts = [s for s, _ in ranges]
        total = 0
        for start, end, _, corr in dev:
            t = launched.get(corr)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= ranges[i][1]:
                total += end - start
        if ranges:
            out[span] = total / 1e9
    return out


def _host_at(t: int, host: List[tuple]) -> str:
    """The harness span and the innermost host operation open at t (an
    operator before a CUDA runtime call inside it)."""
    span, best = "between predicts", (False, -1, "")
    for start, end, name in host:
        if start <= t <= end:
            if name in SPANS:
                if span == "between predicts" or name in ("encode", "decode"):
                    span = name
            else:
                best = max(best, (not name.startswith("cuda"), start, name))
    return f"{span}: {best[2]}" if best[2] else span


def reduce(prof) -> Trace:
    dev, host, launched = _raw_events(prof)
    kernels: Dict[str, List] = {}
    for start, end, name, _ in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (end - start) / 1e9
        k[1] += 1
    busy, gaps, last_end = 0, [], None
    for start, end, *_ in sorted(dev):
        if last_end is None or start > last_end:
            if last_end is not None:
                gaps.append((start - last_end, last_end))
            busy += end - start
            last_end = end
        elif end > last_end:
            busy += end - last_end
            last_end = end
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    top_gaps = heapq.nlargest(TOP, gaps)
    return Trace(busy / 1e9, {n: (s, c) for n, (s, c) in kernels.items()},
                 _span_seconds(dev, host, launched),
                 [[n[:160], s] for n, (s, _) in top_ops],
                 [[_host_at(at + g // 2, host)[:160], g / 1e9] for g, at in top_gaps])
