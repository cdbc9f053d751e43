"""encoder.us_per_frame: the device time of the operations launched inside
the model's ``encode`` calls (the harness's profiler range around each call
inside ``predict``; ``devtrace.py`` ties each operation to its launch),
summed over a traced run's profiled part and divided by the frames encoded
there. The host's pace does not enter it: a gap between two of the
encoder's kernels is no device time."""

LAYER = "autoencoder"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()


def read(ctx):
    s, n = ctx.trace.span_s.get("encode"), ctx.frames["encode"]
    return 1e6 * s / n if s and n else None
