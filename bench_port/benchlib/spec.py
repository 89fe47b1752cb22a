"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry, whose
``file`` holds the model's ``DPFConfig`` fields) and a traffic mix
(``bench_port/traffic/<traffic>.json``); its limits for ``correct`` are in
``bench_port/limits/<cell>.json`` and each per-layer metric is read by
``bench_port/metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# keys of a configuration file that are not DPFConfig fields
CONFIG_META = ("source", "assumed", "reduced", "why")


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def read_config(path: Path) -> tuple:
    """A configuration file's ``DPFConfig`` fields, and the rest."""
    fields = _json(path)
    return fields, {k: fields.pop(k) for k in CONFIG_META if k in fields}


def cell(name: str) -> dict:
    """Everything one cell needs: its entry, its configuration's fields, its
    traffic, its limits and the metrics it reports.  Raises ``KeyError`` for
    a name ``BENCHMARK.json`` does not hold."""
    spec = benchmark()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    fields, meta = read_config(ROOT / config["file"])

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {
        "entry": entry,
        "config": config,
        "config_fields": fields,
        "config_meta": meta,
        "traffic": _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        "limits": _json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
        "per_layer": [m for m in spec["per_layer"] if reports(m)],
    }


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``bench_port/metrics/<name>.py``."""
    import importlib.util

    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
