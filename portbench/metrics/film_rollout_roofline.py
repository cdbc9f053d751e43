"""film_rollout_roofline: kernel 1's FiLM plan (the conditional
propagator's fused rollout, one launch per predict for every step) as a
share of its roofline: the least time the card could take for the traced
predicts' calls (``work.rollout_work``: the products of every step and each
sample's conditioning at the bf16 peak, or z0, the outputs and the weights
moved once at the memory rate, whichever is larger) over the device time of
the kernel named by PATTERNS in the trace. A program without that kernel
(the conditional steps as modules) reads nothing."""

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("twophase_cond.latents.b2048",)
PATTERNS = ("::rollout_film_kernel",)


def read(ctx):
    t = ctx.trace.device_s(PATTERNS)
    bound = ctx.work["bounds"]["prop_rollout"].s
    return 100 * ctx.traced.count * bound / t if t and bound else None
