"""BENCHMARK.json against the contract's shape, and every cell against the
files it names."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest
from conftest import BENCH, CELLS, ROOT

from benchlib import check, spec

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["bench_port"]
    assert b["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in b["workloads"]]:
        assert spec.NAME.match(name), name
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in b["configs"]] + [w["why"] for w in b["workloads"]] \
            + [m["layer"] for m in b["per_layer"]] + [c["source"] for c in b["configs"]]:
        assert LINE.match(text), text


def test_metrics_follow_the_contract():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["source"] == "device_trace"
    assert any("mfu" in m["name"] for m in b["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    from nfdpf_torch import DPFConfig

    cell = spec.cell(name)
    assert cell["entry"]["chips"] == 1
    fields = {f.name for f in dataclasses.fields(DPFConfig)}
    assert set(cell["config_fields"]) <= fields
    assert cell["config_meta"]["reduced"] == cell["config"]["reduced"] == []
    assert set(cell["limits"]) == set(check.NUMBERS)
    for key in ("batch_size", "num_particles", "sequence_length", "ess_threshold",
                "work_items", "work_seed", "check_steps", "simulator"):
        assert key in cell["traffic"], key
    assert {m["name"] for m in cell["end_to_end"]} == {"train_transitions_per_s",
                                                       "peak_mem_gib", "setup_s"}
    for m in cell["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_every_config_is_used_and_every_file_is_its_own():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for f in files:
        assert f.startswith("bench_port/") and (ROOT / f).is_file()
