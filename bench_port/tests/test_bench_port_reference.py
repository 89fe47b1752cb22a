"""The plain reference against the port's plain CPU route at a tiny size:
one whole run of each configuration on the CPU, the compared numbers at
rounding."""

from __future__ import annotations

import pytest
from conftest import CONFIGS, TINY, config_cell

import run


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("gate", [0.5, 1.01])
def test_reference_follows_the_port_on_the_cpu(config, gate):
    """Both configurations, with the default gate and with every step
    resampling (N=16 keeps the default gate from firing), so the OT
    resampler, the flows and the CRNVP measurement all take part."""
    overrides = dict(TINY, ess_threshold=gate)
    out = run.run_cell(config_cell(config), 2**31 + 7, 0.2, False, device="cpu",
                       overrides=overrides)
    result, checked = out["result"], out["extra"]["checked"]
    assert result["correct"] is True
    assert checked["firings"] == checked["ref_firings"]
    assert checked["iters"] == checked["ref_iters"]
    if gate > 1:
        assert sum(checked["firings"]) == TINY["sequence_length"] * len(checked["firings"])
    numbers = {k: v["value"] for k, v in result["check"].items()}
    assert numbers["loss_gap"] <= 1e-6 and numbers["ae_loss_gap"] <= 1e-6
    assert numbers["grad_gap"] <= 1e-4 and numbers["update_gap"] <= 1e-2
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"train_transitions_per_s", "peak_mem_gib", "setup_s"}


def test_traced_run_reads_its_metrics_on_the_cpu():
    out = run.run_cell(config_cell("nf_dpf"), 3, 0.2, True, device="cpu", overrides=TINY)
    result = out["result"]
    assert result["correct"] is True
    assert "step_mfu" in result["metrics"]
    assert out["extra"]["trace"]["coupling_calls"] > 0
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_window_does_the_same_work_whatever_the_seed():
    """Each pass over the work set starts from the initial weights with a
    fresh Adam, so the window's losses repeat pass after pass and do not
    follow the run's seed, which draws only the checked steps."""
    items = TINY["work_items"]
    runs = [run.run_cell(config_cell("bootstrap_dpf"), seed, 0.0, False, device="cpu",
                         overrides=dict(TINY, ess_threshold=1.01)) for seed in (5, 2**31 + 99)]
    windows = [r["extra"]["window"]["losses"] for r in runs]
    assert windows[0] == windows[1] and len(windows[0]) == items
    assert runs[0]["extra"]["checked"]["loss"] != runs[1]["extra"]["checked"]["loss"]
    cfg, traffic = run.build_config(config_cell("bootstrap_dpf"), dict(TINY, ess_threshold=1.01))
    program = run.Program(cfg, traffic, 7, "cpu", {})
    passes = [float(program.step()["loss"]) for _ in range(2 * items)]
    assert passes == windows[0] * 2
