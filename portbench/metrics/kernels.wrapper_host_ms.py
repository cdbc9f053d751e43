"""kernels.wrapper_host_ms: the host time spent inside the hand-written
kernels' Python wrappers (shape checks, the C side's limit over ctypes,
the output and scratch allocated, the launch), from each wrapper's entry
to its return: every ``<wrapper>.host_ns`` counter's change over the
program's ``lns.predict`` spans of a traced run's profiled part, summed and
divided by their count. Nothing launches on the CPU: nothing to read."""

LAYER = "kernels"
SOURCE = "program_span"
MOVES = "predict_p95_ms"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()

from recorded import counter_per_predict  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    ns = counter_per_predict(ctx, ".host_ns")
    return ns / 1e6 if ns else None
