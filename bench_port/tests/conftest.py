"""Shared set-up of the benchmark's own tests: the harness's folder on the
path, one torch thread, and the tiny traffic the CPU runs use."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

# a run of any cell at a size the CPU holds: B=2, N=16, T=3, three steps
TINY = {"batch_size": 2, "num_particles": 16, "sequence_length": 3, "work_items": 3,
        "simulator": {"num_distractors": 25, "pos_noise": 2.0, "chunk": 4}}
# every cell of BENCHMARK.json, and every configuration file
CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
CONFIGS = tuple(sorted(p.stem for p in (BENCH / "configs").glob("*.json")))


def config_cell(config: str) -> dict:
    """The first cell with the named configuration in place of its own, so
    that every configuration file is tested, a cell of its own or not
    (the NF-DPF's cell waits: PERF.md, Open questions)."""
    from benchlib import spec

    fields, meta = spec.read_config(BENCH / "configs" / f"{config}.json")
    return dict(spec.cell(CELLS[0]), config_fields=fields, config_meta=meta)


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
