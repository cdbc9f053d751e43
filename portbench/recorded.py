"""What the program under test recorded of a traced run's profiled part:
the spans of ``lns_tpu_torch.utils.profiling``, which record while the
profiler runs, among them one ``lns.predict`` per predict carrying every
counter's change over it (each kernel wrapper's launches, scratch bytes
and host time). A program without spans gives None, and so does every
reader of them."""

from __future__ import annotations

import sys


def predicts(ctx):
    """(every span record, the ``lns.predict`` records) of the traced
    part; None where the program has no spans or did not record one
    ``lns.predict`` per traced predict."""
    from lns_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    records = read()
    roots = [r for r in records if r.name == "lns.predict"]
    if len(roots) != ctx.traced.count:
        print(f"recorded.py: {len(roots)} lns.predict spans against {ctx.traced.count} traced "
              "predicts: no reading", file=sys.stderr)
        return None
    return (records, roots) if roots else None


def counter_per_predict(ctx, suffix: str):
    """The changes of every counter whose key ends in `suffix` over the
    traced predicts, summed and divided by their count; None where no such
    counter changed."""
    got = predicts(ctx)
    if got is None:
        return None
    roots = got[1]
    deltas = [v for r in roots for k, v in r.attrs.get("counters", {}).items()
              if k.endswith(suffix)]
    return sum(deltas) / len(roots) if deltas else None
