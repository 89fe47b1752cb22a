"""What the harness and the reference load, by whole top-level module
names, in fresh processes; and how a run ends where it cannot measure."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, CELLS, ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "nfdpf_tpu"}


def _python(code: str, cwd=ROOT, timeout: int = 600) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _top_names(code: str) -> set:
    probe = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = _python(probe)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    code = ("import torch; torch.set_num_threads(1); import run, readings\n"
            "from benchlib import spec\n"
            f"cell = spec.cell({CELLS[0]!r})\n"
            f"fields, meta = spec.read_config(spec.BENCH_DIR / 'configs' / 'nf_dpf.json')\n"
            "nf_dpf = dict(cell, config_fields=fields, config_meta=meta)\n"
            f"run.run_cell(nf_dpf, 5, 0.1, True, device='cpu', overrides={TINY!r})\n"
            f"run.run_cell(cell, 5, 0.1, False, device='cpu', overrides={TINY!r})\n"
            "import glob, importlib.util\n"
            f"for p in glob.glob({str(BENCH / 'metrics' / '*.py')!r}):\n"
            "    s = importlib.util.spec_from_file_location('m', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))")
    names = _top_names(code)
    assert "nfdpf_torch" in names          # the comparison is by whole names:
    assert not names & FORBIDDEN, names & FORBIDDEN   # nfdpf_torch is not nfdpf_tpu


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names("import reference.model")
    assert not names & (FORBIDDEN | {"nfdpf_torch", "benchlib", "run"})
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & (FORBIDDEN | {"nfdpf_torch"}), (path.name, tops)


def test_the_harness_sources_import_no_jax():
    for path in list(BENCH.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0], "--seed",
                           "2147483999", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_alone_in_a_directory_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
