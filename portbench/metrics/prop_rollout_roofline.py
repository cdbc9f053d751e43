"""prop_rollout_roofline: kernel 1 (the fused rollout, one launch per
predict for every step) as a share of its roofline: the least time the card
could take for the traced predicts' calls (``work.rollout_work``: the
products of every step at the bf16 peak, or z0, the outputs and the weights
moved once at the memory rate, whichever is larger) over the device time of
the kernels named by PATTERNS in the trace."""

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ("::rollout_bf16_kernel", "::rollout_kernel")


def read(ctx):
    t = ctx.trace.device_s(PATTERNS)
    bound = ctx.work["bounds"]["prop_rollout"].s
    return 100 * ctx.traced.count * bound / t if t and bound else None
