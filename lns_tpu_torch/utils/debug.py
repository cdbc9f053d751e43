"""NaN detection and finite checks (counterpart of ``lns_tpu.utils.debug``).

- ``nan_debugging``: inside it, the first module whose forward output holds
  a NaN raises ``FloatingPointError`` naming the module (the JAX package's
  ``jax_debug_nans`` raises at the op that made the NaN), and autograd's
  anomaly mode checks the backward for NaNs;
- ``assert_finite``: a host-side check of a tree of tensors or arrays,
  with the JAX function's message;
- ``check_finite_in_jit``: the identity, as the JAX function is (its print
  is switched off there).
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch
from torch import nn


def _has_nan(out) -> bool:
    """Whether a forward output (a tensor, or tuples, lists and dicts of
    them) holds a NaN; reads the value on the host."""
    if isinstance(out, torch.Tensor):
        return (out.is_floating_point() or out.is_complex()) and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_has_nan(o) for o in out)
    if isinstance(out, dict):
        return any(_has_nan(o) for o in out.values())
    return False


def _nan_hook(module: nn.Module, args, out):
    if _has_nan(out):
        raise FloatingPointError(f"NaN in the output of {type(module).__name__}"
                                 f"({module.extra_repr()})")


@contextlib.contextmanager
def nan_debugging(enabled: bool = True):
    """Inside the context, every module's forward output is checked for
    NaNs (a global forward hook; it waits for the device at each module)
    and the first that holds one raises ``FloatingPointError`` naming the
    module; the backward runs under ``torch.autograd.set_detect_anomaly``
    with ``check_nan``. With `enabled` False both are off inside the
    context. The earlier anomaly mode is restored on exit."""
    mode, check_nan = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    handle = (nn.modules.module.register_module_forward_hook(_nan_hook) if enabled
              else None)
    torch.autograd.set_detect_anomaly(enabled, check_nan=enabled)
    try:
        yield
    finally:
        if handle is not None:
            handle.remove()
        torch.autograd.set_detect_anomaly(mode, check_nan=check_nan)


def _leaves(tree, path=""):
    """(keystr, leaf) of a tree of dicts, lists and tuples in the order
    ``jax.tree_util.tree_flatten_with_path`` gives them: a dict's keys
    sorted, an ``OrderedDict``'s (a state dict's) in their order, each
    written as ``keystr`` writes it (``['a']``, ``[0]``); None is an empty
    subtree."""
    if isinstance(tree, dict):
        for k in tree if isinstance(tree, collections.OrderedDict) else sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "tree"):
    """Raise ``FloatingPointError`` naming the first leaf of `tree` (nested
    dicts, lists and tuples of tensors, arrays or numbers; a state dict)
    that holds a NaN or an infinity. Host-side: it waits for the device."""
    for keystr, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            finite = bool(torch.isfinite(leaf).all())
        else:
            finite = bool(np.all(np.isfinite(np.asarray(leaf))))
        if not finite:
            raise FloatingPointError(f"non-finite values in {name}{keystr}")


def check_finite_in_jit(x, label: str = "value"):
    """`x`, unchanged and not read: the JAX function's warning print is
    switched off (``lns_tpu/utils/debug.py``), so it checks nothing, and
    nothing here waits for the device."""
    return x
