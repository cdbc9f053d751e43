"""Checkpoint conversion between the JAX package's parameter trees and the
port's state dicts (``convert``), flax's msgpack format without flax
(``msgpack``), and the debug (``debug``: NaN detection, finite checks) and
profiling helpers (``profiling``: traces, timers, chained timing, the
program's spans and counters)."""

from lns_tpu_torch.utils.debug import assert_finite, check_finite_in_jit, nan_debugging  # noqa: F401
from lns_tpu_torch.utils.profiling import Timer, time_fn, trace  # noqa: F401
