"""propagator.conditioning_ms: the host time of the program's
``lns.conditioning`` span (a conditional propagator's embedding, its MLP and
each block's projection and FiLM scale, computed once a predict from each
sample's parameter), summed over a traced run's profiled part and divided by
the ``lns.predict`` spans there. A program whose predict records no such
span reads nothing."""

LAYER = "propagator"
SOURCE = "program_span"
MOVES = "predict_p95_ms"
WORKLOADS = ("twophase_cond.latents.b2048",)
PATTERNS = ()

from recorded import predicts  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    got = predicts(ctx)
    if got is None:
        return None
    records, roots = got
    ids = {r.id for r in roots}
    ns = [r.end_ns - r.start_ns for r in records
          if r.name == "lns.conditioning" and r.predict in ids]
    return sum(ns) / 1e6 / len(roots) if ns else None
