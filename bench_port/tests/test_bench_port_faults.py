"""A run with its timed path broken underneath comes out not correct, and
so does the control, the program's bfloat16 path (a run of the harness
with the look for a card skipped, at a tiny size on the CPU)."""

from __future__ import annotations

import pytest
from conftest import CONFIGS, TINY, config_cell

import readings
import run
from benchlib import check
from nfdpf_torch.train import Trainer


def _unchanged(self, batch, noise=None, generator=None):
    """A step that computes its loss and returns its state unchanged."""
    import torch

    with torch.no_grad():
        loss, aux = self._loss(batch, True, noise, generator)
    return self._metrics(loss, aux)


def _half_batch(self, batch, noise=None, generator=None):
    half = batch["image"].shape[0] // 2
    batch = {k: v[:half] for k, v in batch.items()}
    noise = {k: (v[:, :half] if k == "motion" else v[:half]) for k, v in noise.items()}
    return _ORIGINAL(self, batch, noise=noise, generator=generator)


_ORIGINAL = Trainer.train_step


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(monkeypatch, config, fault):
    monkeypatch.setattr(Trainer, "train_step", fault)
    overrides = dict(TINY, batch_size=4)
    out = run.run_cell(config_cell(config), 11, 0.1, False, device="cpu", overrides=overrides)
    assert out["result"]["correct"] is False
    worst = {k: v["value"] / v["limit"] for k, v in out["result"]["check"].items()}
    assert max(worst.values()) > 1.0


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_is_not_correct(config):
    cell = config_cell(config)
    for seed in (21, 22, 23):
        r = readings.reading(cell, seed, "control", "cpu", TINY)
        assert not check.verdict(r, cell["limits"]), (seed, r)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_planted_fault_of_the_readings_is_not_correct(config):
    cell = config_cell(config)
    r = readings.reading(cell, 31, "half_batch", "cpu", dict(TINY, batch_size=4))
    assert not check.verdict(r, cell["limits"])
