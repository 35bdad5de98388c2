"""A later change adds a configuration, a cell and a per-layer metric by
files and manifest entries alone: in a copy of the benchmark, the harness
takes all three and edits no file it already had."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_by_files_alone(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "portbench")
    bench = tmp_path / "portbench"
    # a configuration: the realtime model (shared backbone at 1/8, two GRU
    # levels, slow-fast GRU)
    cfg = json.loads((bench / "configs" / "raftstereo.json").read_text())
    cfg["name"] = "realtime-2gru"
    cfg["model"].update(n_gru_layers=2, n_downsample=3, shared_backbone=True, slow_fast_gru=True)
    (bench / "configs" / "realtime-2gru.json").write_text(json.dumps(cfg))
    # a cell of it, driven by an existing driver through a traffic file
    cell = json.loads((bench / "workloads" / "raftstereo.middlebury-f.json").read_text())
    cell.update(config="realtime-2gru", sizes=[[60, 100]], pool_pairs=2, iters=2, batch=2,
                check={"pairs": 1}, disparity_px=[2, 24])
    (bench / "workloads" / "realtime-2gru.tiny.json").write_text(json.dumps(cell))
    # a per-layer metric with a reader of its own
    (bench / "metrics" / "batches.batch.py").write_text(
        "def read(run):\n    s = run.sources.get('engine_stats')\n"
        "    return None if s is None else float(s.batches)\n")
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "realtime-2gru", "source": "a test",
                           "file": "portbench/configs/realtime-2gru.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "realtime-2gru.tiny", "config": "realtime-2gru",
                             "traffic": "tiny", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("realtime-2gru.tiny")
    man["per_layer"].append({"name": "batches.batch", "unit": "batches", "better": "higher",
                             "source": "program_counter", "layer": "Engine",
                             "moves": "pairs_per_s", "workloads": ["realtime-2gru.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    code = f"""
import json, sys, tempfile, time, torch
tempfile.tempdir = {str(tmp_path)!r}
from portbench import harness, run
assert harness.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
man = harness.manifest()
entry, cell, _, config = harness.cell_files(man, "realtime-2gru.tiny")
out = {{}}
for trace in (False, True):
    r = harness.Run(cell=cell, config=config, seconds=0.5, seed=3, trace=trace,
                    device=torch.device("cpu"))
    driver = harness.load_file_module(harness.BENCH_DIR / "drivers" / (cell["entry"] + ".py"), "d")
    driver.run(r, harness.SetupClock(time.perf_counter()))
    out[str(trace)] = sorted(run.metrics_for(man, r, "realtime-2gru.tiny"))
    out["correct"] = r.correct
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(harness.ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["False"] == ["pairs_per_s", "peak_mem_gib", "setup_s"]
    assert got["True"] == ["batches.batch"]
    assert got["correct"]
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
