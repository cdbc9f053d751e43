"""mfu_pct: the whole predict's share of the card's peak: the model FLOPs of
the predicts of a traced run's span part (``work.predict_work``: every conv
and matrix product of the reference's encode, steps and decode as
``FlopCounterMode`` counts them) over that part's wall time at the bf16
tensor-core peak (989 TFLOP/s)."""

LAYER = "whole predict"
SOURCE = "host_clock"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ()

from work import PEAK_BF16  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    s = ctx.spans
    return 100 * s.count * ctx.work["flops"] / (s.wall_s * PEAK_BF16) if s.count else None
