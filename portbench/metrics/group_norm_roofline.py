"""group_norm_roofline: kernel 3 (GroupNorm + swish at every GroupNorm
of the autoencoder, one call each) as a share of its roofline: the least
time the card could take for the traced predicts' calls
(``work.group_norm_work`` at every GroupNorm of the reference encoder and
decoder: bytes bound) over the device time of the kernels named by PATTERNS
in the trace (the cluster kernel, or the split plan's two passes)."""

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256")
PATTERNS = ("::gn_kernel<", "::gn_partials<", "::gn_apply<")


def read(ctx):
    t = ctx.trace.device_s(PATTERNS)
    bound = ctx.work["bounds"]["group_norm"].s
    return 100 * ctx.traced.count * bound / t if t and bound else None
