"""Checkpoint conversion between the JAX package's flax msgpack and the
port's (the reference's) ``.pt``, both directions (counterpart of
``lns_tpu.cli.convert``):

    # flax msgpack -> .pt (loads strictly into the port and the reference)
    python -m lns_tpu_torch.cli.convert --config cfg.yml --input ae.msgpack \\
        --output vqgan_epoch_final.pt [--kind ae|cond_ae|dynamics]

    # .pt -> flax msgpack (what the JAX package's load_pytree reads)
    python -m lns_tpu_torch.cli.convert --config cfg.yml --input model_best.pt \\
        --output model_best.msgpack --kind dynamics

``--kind ae`` is a stage-1 autoencoder (the JAX tree ``{encoder, decoder,
quant_conv, post_quant_conv}``, the ``.pt``'s bare keys; its Fourier layers
included), ``cond_ae`` a ``ConditionalSimpleAutoencoder`` (the same tree,
its encoder the ``CondEncoder``), ``dynamics`` a
stage-2 model (``{vq_ae, propagator}``; ``vq_ae.`` / ``ae.`` and
``propagator.`` keys). Both directions read one key table
(``lns_tpu_torch.utils.convert.key_table``); msgpack is read and written
by ``lns_tpu_torch.utils.msgpack``, so neither flax nor msgpack is needed.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def _sorted(tree):
    """Dict keys sorted at every level, the order in which the JAX package's
    ``save_pytree`` (a ``jax.tree.map`` of the tree) writes them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def convert(cfg, src: str, dst: str, kind: str = "ae") -> None:
    """`src` (``.msgpack`` or ``.pt``) converted to the other format at
    `dst`, written atomically."""
    from lns_tpu_torch.train import checkpoint
    from lns_tpu_torch.utils.msgpack import packb, unpackb
    from lns_tpu_torch.utils.convert import state_dict_from_jax, state_dict_to_jax

    if src.endswith(".pt"):
        tree = state_dict_to_jax(cfg, checkpoint.load_torch_state_dict(src), kind)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            f.write(packb(_sorted(tree)))
        os.replace(tmp, dst)
    elif src.endswith(".msgpack"):
        with open(src, "rb") as f:
            checkpoint.save(state_dict_from_jax(cfg, unpackb(f.read()), kind), dst)
    else:
        raise ValueError(f"{src}: a .pt or a .msgpack file")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from lns_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--kind", choices=["ae", "cond_ae", "dynamics"], default="ae")
    args = p.parse_args(argv)
    convert(load_config(args.config), args.input, args.output, args.kind)
    direction = "torch -> msgpack" if args.input.endswith(".pt") else "msgpack -> torch"
    print(f"wrote {args.output} ({args.kind}, {direction})")


if __name__ == "__main__":
    main()
