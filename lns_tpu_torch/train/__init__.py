"""Training (counterpart of ``lns_tpu.train``): the stage-2 trainer, its
optimizer and schedule, ``.pt`` checkpoints and metric logging. Stage 1 is
not ported yet."""
