"""The three cells read what they read before ``work.py`` counted with each
configuration's own reference module and before a traffic file could carry
``cond``: the work of one predict at each cell's sizes (``predict_work`` on
``meta``: the model FLOPs by part, each kernel's bound and what bounds it,
kernel 1's operations and bytes), and the state dict and input batches made
on the CPU from one seed per cell (sha256 of their bytes), as the harness
computed them when the counts came from ``reference.lns`` alone and the
latent grid from ``round(h * Lx / Ly)``."""

import hashlib
import math

import pytest
import torch

import harness as H
from reference import lns
from work import predict_work

PINS = {
    "ns2d.rollout.b32": {
        "flops": 1161992077312, "encode": 1345093632.0, "step": 182976512, "decode": 1022787584,
        "bounds": {"prop_rollout": (0.00017169080195753286, "operations"),
                   "fab_core": (0.0002464673116926188, "operations"),
                   "group_norm": (0.000681423551044776, "bytes")},
        "rollout": (169802203136, 4837440), "seed": 2147483749,
        "state": "b818901e3e7be1357e9a3b64c3d9acd49903c07d87f4b724a9ed494ced8a8ef8",
        "inputs": "a676fb33b7e1692810239f7569e4b79972c804de318f5964418c9b61573a981f"},
    "ns2d.latents.b256": {
        "flops": 1702761594880, "encode": 1345093632.0, "step": 182976512, "decode": 0,
        "bounds": {"prop_rollout": (0.0013735264156602629, "operations"),
                   "fab_core": (0.0, None),
                   "group_norm": (0.00022286351283582089, "bytes")},
        "rollout": (1358417625088, 18600000), "seed": 8589934599,
        "state": "ef3f5816260f750d8cb5af81031f79204878f87571e411565025086eb773ef1b",
        "inputs": "9b974076a80536ba083efaca073250937875283bc56b14b2d4974dff24ba2223"},
    "sw.rollout.b8": {
        "flops": 2448546594816, "encode": 7547387904.0, "step": 1123024896, "decode": 5984616448,
        "bounds": {"prop_rollout": (0.0003815332305925177, "operations"),
                   "fab_core": (0.0005258995627098079, "operations"),
                   "group_norm": (0.0010898598591044775, "bytes")},
        "rollout": (377336365056, 16531200), "seed": 3000000019,
        "state": "65de10b9a43a01533732e1d107b453ea334e74b3297efb0a073ae17bdd7d3298",
        "inputs": "23e0b938414a0fdc0f5409ada0cd6ce3bd7a201128c17dff05f07beddb020b1c"},
}


def _close(got, want):
    return math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0)


@pytest.mark.parametrize("name", sorted(PINS))
def test_work_of_a_predict_is_pinned(name):
    cell, pin = H.load_cell(H.load_spec(), name), PINS[name]
    t = cell.traffic
    work = predict_work(lns, cell.widths, t["batch"], t["steps"], t["to_x"])
    for k in ("flops", "encode", "step", "decode"):
        assert _close(work[k], pin[k]), k
    assert work["conditioning"] == 0
    for k, (s, by) in pin["bounds"].items():
        assert _close(work["bounds"][k].s, s) and work["bounds"][k].bound_by == by, k
    k1 = work["bounds"]["prop_rollout"]
    assert (k1.flops, k1.nbytes) == pin["rollout"]


def _sha(tensors):
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINS))
def test_weights_and_inputs_are_pinned(name):
    """Bitwise the same tensors from the seed, and no draw after the fields."""
    cell, pin = H.load_cell(H.load_spec(), name), PINS[name]
    gen = H.generator(pin["seed"], "cpu")
    state = H.make_state_dict(lns, cell.widths, gen, "cpu")
    inputs = H.make_inputs(cell, gen, "cpu")
    assert _sha(state.items()) == pin["state"]
    assert _sha(("", i["x"]) for i in inputs) == pin["inputs"]
    ref = H.generator(pin["seed"], "cpu")
    H.make_state_dict(lns, cell.widths, ref, "cpu")
    w, t = cell.widths, cell.traffic
    torch.randn(t["inputs"], t["batch"], w["Ly"], w["Lx"], w["in_channels"], generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
