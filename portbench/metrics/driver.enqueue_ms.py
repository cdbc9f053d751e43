"""driver.enqueue_ms: the host's time from the call of ``predict`` to its
return, before any synchronize, summed over the predicts of a traced run's
span part and divided by their count. Where it nears the predict's latency,
the host sets the pace and the card waits."""

LAYER = "rollout driver"
SOURCE = "host_clock"
MOVES = "predict_p95_ms"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()


def read(ctx):
    e = ctx.spans.enqueue_s
    return 1e3 * sum(e) / len(e) if e else None
