"""fab_core_roofline: kernel 2 (the factorized-attention core, one call
per FAB block of each decode; four passes in bf16) as a share of its
roofline: the least time the card could take for the traced predicts' calls
(``work.fab_work`` at every FAB site of the reference decoder) over the
device time of the kernels named by PATTERNS in the trace."""

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8")
PATTERNS = ("::fab_block_mean_bf16", "::fab_bb_stats_bf16", "::fab_moments_bf16",
            "::fab_out_bf16", "::fab_stats_f32", "::fab_apply_f32")


def read(ctx):
    t = ctx.trace.device_s(PATTERNS)
    bound = ctx.work["bounds"]["fab_core"].s
    return 100 * ctx.traced.count * bound / t if t and bound else None
