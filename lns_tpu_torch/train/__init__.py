"""Training (counterpart of ``lns_tpu.train``): the stage-1 autoencoder
trainer, the stage-2 propagator trainer (both data-parallel under a
process group), their optimizers, ``.pt`` checkpoints (also written in the
background) and metric logging."""

from lns_tpu_torch.train.stage1 import Stage1Trainer  # noqa: F401
from lns_tpu_torch.train.stage2 import Stage2Trainer  # noqa: F401
