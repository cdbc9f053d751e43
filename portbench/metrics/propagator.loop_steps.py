"""propagator.loop_steps: the samples the program steps through its module
loop per predict (``lns.rollout`` path "loop": one per sample per step), the
change of its ``latent_dynamics.LOOP_STEPS`` counter over the ``lns.predict``
spans of a traced run's profiled part, divided by their count: 0 where
kernel 1 ran the rollout, batch x steps where the steps ran as modules. A
program without that counter reads nothing."""

LAYER = "propagator"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ("ns2d.rollout.b32", "sw.rollout.b8", "ns2d.latents.b256",
             "twophase_cond.latents.b2048")
PATTERNS = ()

from recorded import predicts  # noqa: E402  (the benchmark folder is on sys.path)


def read(ctx):
    from lns_tpu_torch.models import latent_dynamics

    key = getattr(latent_dynamics, "LOOP_STEPS", None)
    got = predicts(ctx) if key else None
    if got is None:
        return None
    roots = got[1]
    return sum(r.attrs["counters"].get(key, 0) for r in roots) / len(roots)
