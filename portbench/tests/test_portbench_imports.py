"""Nothing the benchmark runs loads the JAX package or JAX: compared by
each module's whole top-level name, since the port's name begins with the
JAX package's."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import harness

SOURCES = sorted(p for p in harness.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_sources_name_no_forbidden_module(path):
    assert not set(imported_top_levels(path)) & set(harness.FORBIDDEN_MODULES)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        names = set(imported_top_levels(path))
        assert names <= {"__future__", "contextlib", "math", "typing", "torch", "portbench"}, path


def test_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raft_stereo_tpu_torch_fake", object())
    assert "raft_stereo_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "raft_stereo_tpu.fake_sub", object())
    monkeypatch.setitem(sys.modules, "jaxlib.fake_sub", object())
    assert {"raft_stereo_tpu", "jaxlib"} <= set(harness.forbidden_loaded())


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A fresh process that imports every piece of the harness and drives a
    tiny cell on the CPU holds no module of the JAX package or JAX."""
    code = f"""
import json, sys, tempfile
tempfile.tempdir = {str(tmp_path)!r}
sys.path.insert(0, {str(harness.BENCH_DIR / "tests")!r})
from conftest import drive, tiny_run
from portbench import calibrate, harness, run
for p in sorted((harness.BENCH_DIR / "metrics").glob("*.py")):
    harness.load_file_module(p, "m_" + p.stem.replace(".", "_"))
r = drive(tiny_run("raftstereo.middlebury-f", seconds=0.5))
print(json.dumps({{"loaded": harness.forbidden_loaded(), "correct": r.correct}}))
"""
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"loaded": [], "correct": True}
