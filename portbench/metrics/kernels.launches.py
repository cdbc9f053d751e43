"""kernels.launches: the hand-written kernels launched per predict: every
``<wrapper>.launches`` counter's change over the program's ``lns.predict``
spans of a traced run's profiled part, summed and divided by their count.
Nothing launches on the CPU: nothing to read."""

LAYER = "kernels"
SOURCE = "program_counter"
MOVES = "predict_p95_ms"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()

from recorded import counter_per_predict  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    return counter_per_predict(ctx, ".launches")
