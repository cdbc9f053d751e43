"""device.idle_pct: the share of a predict in which no operation ran on the
card: 1 - the device's busy time per predict in a traced run's profiled
part (the union of every kernel, copy and set in the trace) / the wall time
per predict in its first part, untraced (the profiler slows the host, not
the card's work)."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()


def read(ctx):
    if not (ctx.trace.busy_s and ctx.traced.count and ctx.spans.count):
        return None
    return 100 * (1 - (ctx.trace.busy_s / ctx.traced.count) / (ctx.spans.wall_s / ctx.spans.count))
