"""kernels.scratch_mb: the device memory the hand-written kernels'
wrappers allocate per predict besides their outputs (kernel 2's bb, Gram,
m, bias and mean; kernel 3's split-plan workspace; kernel 1's f32
workspace; the copies of arguments they hand a kernel), in 1e6 bytes:
every ``<wrapper>.scratch_bytes`` counter's change over the program's
``lns.predict`` spans of a traced run's profiled part, summed and divided
by their count. Nothing launches on the CPU: nothing to read."""

LAYER = "kernels"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8")
PATTERNS = ()

from recorded import counter_per_predict  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    b = counter_per_predict(ctx, ".scratch_bytes")
    return b / 1e6 if b else None
