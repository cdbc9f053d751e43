"""Command-line entry points (counterpart of ``lns_tpu.cli``)."""
