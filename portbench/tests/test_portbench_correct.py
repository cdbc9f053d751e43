"""What decides ``correct``, driven on the CPU at sizes a test run holds
(batch 2, 3 steps; SW batch 1, 2 steps), the widths as published: a sound
run passes every limit, the control (the reference in fp8 in the program's
place) fails one, and a run whose timed path is broken underneath comes out
not correct for each fault a cell can have."""

import time

import pytest
import torch

import control
import harness as H
import run
from lns_tpu_torch.models import latent_dynamics
from lns_tpu_torch.models.autoencoder import SimpleAutoencoder

SIZES = {"ns2d": dict(batch=2, steps=3, inputs=2), "sw": dict(batch=1, steps=2, inputs=2)}
CELLS = ["ns2d.rollout.b32", "ns2d.latents.b256", "sw.rollout.b8"]


def _cell(name):
    cell = H.load_cell(H.load_spec(), name)
    cell.traffic.update(SIZES[cell.config_name])
    return cell


def _run(name):
    return run.run_cell(_cell(name), 2**31 + 77, 0.1, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["attempted"] >= H.SAMPLES
    assert list(r)[-1] == "checked" and set(r["checked"]) == set(_cell(name).limits["numbers"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    cell = _cell(name)
    rows = control.read_seeds(cell, [2**31 + 5], 1, 0.1, torch.device("cpu"), lambda: None,
                              log=lambda s: None)
    limits = cell.limits["numbers"]
    assert all(v <= limits[k]["limit"] for k, v in rows[0]["program"].items())
    assert any(v > limits[k]["limit"] for k, v in rows[0]["control"].items())


def _state_unchanged(orig):
    def fault(z, packed, steps, *args):
        return z[None].expand((steps,) + tuple(z.shape)).clone()
    return fault


def _half_batch(orig):
    def fault(z, packed, steps, *args):
        out = orig(z, packed, steps, *args)
        out[:, z.shape[0] // 2:] = 0
        return out
    return fault


def _latent_altered(orig):
    def fault(z, packed, steps, *args):
        out = orig(z, packed, steps, *args)
        out[1, 0] = -out[1, 0]
        return out
    return fault


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _latent_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["ns2d.rollout.b32", "ns2d.latents.b256"])
def test_broken_rollout_is_not_correct(monkeypatch, name, fault):
    """The rollout broken where predict calls it: a step that returns its
    state unchanged, half of the batch left out, one latent altered."""
    monkeypatch.setattr(latent_dynamics, "fused_rollout",
                        FAULTS[fault](latent_dynamics.fused_rollout))
    assert not _run(name)["correct"]


def test_altered_frame_is_not_correct(monkeypatch):
    """One decoded frame altered where the decoder produces it."""
    orig = SimpleAutoencoder.decode

    def decode(self, z):
        y = orig(self, z)
        y[0] = -y[0]
        return y
    monkeypatch.setattr(SimpleAutoencoder, "decode", decode)
    assert not _run("ns2d.rollout.b32")["correct"]
