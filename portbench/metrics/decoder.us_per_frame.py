"""decoder.us_per_frame: the device time of the operations launched inside
the model's ``decode`` calls (the harness's profiler range around each call
inside ``predict``; ``devtrace.py`` ties each operation to its launch),
summed over a traced run's profiled part and divided by the frames decoded
there. Cells that return latents decode nothing and read nothing."""

LAYER = "autoencoder"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8")
PATTERNS = ()


def read(ctx):
    s, n = ctx.trace.span_s.get("decode"), ctx.frames["decode"]
    return 1e6 * s / n if s and n else None
