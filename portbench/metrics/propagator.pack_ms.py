"""propagator.pack_ms: the host time of the program's ``lns.pack`` span
(``pack_simple_cnn``: the propagator's weights cast, stacked and made
contiguous in kernel 1's layout, anew on every predict), summed over a
traced run's profiled part and divided by the ``lns.predict`` spans there.
A program whose predict records no such span reads nothing."""

LAYER = "propagator"
SOURCE = "program_span"
MOVES = "predict_p95_ms"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()

from recorded import predicts  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    got = predicts(ctx)
    if got is None:
        return None
    records, roots = got
    ids = {r.id for r in roots}
    ns = [r.end_ns - r.start_ns for r in records if r.name == "lns.pack" and r.predict in ids]
    return sum(ns) / 1e6 / len(roots) if ns else None
