"""The port stands alone and runs where it is asked to.

Importing every module of ``raft_stereo_tpu_torch`` (and ``chip_smoke.py``)
loads neither JAX, Flax, optax, OpenCV nor the JAX package; the entry points refuse to
fall back to the CPU silently; the demo entry point runs end to end on the
CPU when asked to.
"""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_stereo_tpu_torch
from raft_stereo_tpu_torch import demo, evaluate
from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.ops import alt_corr

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "cv2", "raft_stereo_tpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _forbidden(name: str) -> bool:
    # exact names and their submodules: raft_stereo_tpu_torch is not raft_stereo_tpu
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    pkg = raft_stereo_tpu_torch.__path__
    return ["raft_stereo_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(pkg, prefix="raft_stereo_tpu_torch.")
    ]


def test_forbidden_prefix_check_is_exact():
    assert _forbidden("raft_stereo_tpu") and _forbidden("raft_stereo_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert _forbidden("optax") and _forbidden("cv2")
    assert not _forbidden("raft_stereo_tpu_torch") and not _forbidden("jaxtyping")


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "raft_stereo_tpu_torch.ops.alt_corr" in loaded
    assert "raft_stereo_tpu_torch.ops.fused_update" in loaded
    assert "raft_stereo_tpu_torch.runtime.infer" in loaded
    assert "raft_stereo_tpu_torch.data.datasets" in loaded
    for m in ("train", "losses", "runtime.loop", "runtime.checkpoint", "parallel.train_step",
              "data.augmentor", "native", "runtime.telemetry", "runtime.faultinject",
              "models.madnet2", "models.attention", "models.madnet2_fusion", "evaluate_mad",
              "train_mad", "serve_adaptive", "runtime.adapt", "runtime.tiers",
              "runtime.controller", "runtime.debug_server", "runtime.fleet", "serve_fleet"):
        assert f"raft_stereo_tpu_torch.{m}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_source_of_the_port_names_jax():
    files = sorted((REPO / "raft_stereo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{f.relative_to(REPO)} imports {bad}"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(PRESETS["raftstereo-middlebury"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--output_directory", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--dataset", "eth3d"])
    model = load_model(PRESETS["raftstereo-middlebury"], device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    # the MADNet2 family's entry points
    from raft_stereo_tpu_torch import evaluate_mad, serve_adaptive, train_mad

    monkeypatch.chdir(tmp_path)
    for main, argv in ((evaluate_mad.main, []), (train_mad.main, ["--num_steps", "1"]),
                       (serve_adaptive.main, ["--source", "synthetic"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    # a fleet worker's engine factory (the router itself holds no model)
    from raft_stereo_tpu_torch import serve_fleet

    for model in ("madnet2", "toy"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_fleet.build_engine({"model": model})


def test_demo_runs_end_to_end_on_the_cpu(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    for k in range(2):
        d = tmp_path / "pairs" / f"scene{k}"
        d.mkdir(parents=True)
        for name in ("im0.png", "im1.png"):
            Image.fromarray((rng.rand(45, 70, 3) * 255).astype(np.uint8)).save(d / name)
    before = alt_corr.LAUNCHES
    run = demo.main([
        "--preset", "raftstereo-middlebury", "--valid_iters", "2",
        "--corr_levels", "2", "--corr_radius", "2",
        "--left_imgs", str(tmp_path / "pairs" / "*" / "im0.png"),
        "--right_imgs", str(tmp_path / "pairs" / "*" / "im1.png"),
        "--output_directory", str(tmp_path / "out"), "--save_numpy",
    ], device="cpu")
    assert run.saved == 2 and run.engine is not None  # the engine is the default path
    assert run.graphs is None  # nothing is captured on the CPU
    assert alt_corr.LAUNCHES == before  # CPU tensors take the plain version
    for k in range(2):
        disp = np.load(tmp_path / "out" / f"scene{k}.npy")
        assert disp.shape == (45, 70) and np.isfinite(disp).all()
        assert (tmp_path / "out" / f"scene{k}.png").is_file()


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:  # a directory that holds the script alone
            script = tmp_path / "chip_smoke.py"
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_library_name_hashes_every_header_a_kernel_includes(tmp_path, monkeypatch):
    """An edited header rebuilds every kernel that includes it, directly or
    through another header, and no other (no nvcc needed: only the
    library's name is computed)."""
    from raft_stereo_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert [p.name for p in _build._sources("fused_update")] == [
        "fused_update.cu", "conv3x3_sm90.cuh"]
    assert [p.name for p in _build._sources("packed_conv")] == [
        "packed_conv.cu", "conv3x3_sm90.cuh"]
    assert [p.name for p in _build._sources("alt_corr")] == ["alt_corr.cu"]
    names = ("alt_corr", "fused_update", "packed_conv")

    def paths():
        return {k: _build._lib_path(k) for k in names}

    before = paths()
    (csrc / "unused.cuh").write_text("// included by no kernel\n")
    assert paths() == before
    # the bf16 conv mainloop K2 and K3 share
    mainloop = csrc / "conv3x3_sm90.cuh"
    mainloop.write_text(mainloop.read_text() + "// edited\n")
    shared = paths()
    assert [k for k in names if shared[k] != before[k]] == ["fused_update", "packed_conv"]
    edited = shared
    src = csrc / "fused_update.cu"
    src.write_text(src.read_text() + "// edited\n")
    assert paths()["alt_corr"] == edited["alt_corr"]
    assert paths()["fused_update"] != edited["fused_update"]
    edited = paths()
    src = csrc / "alt_corr.cu"
    src.write_text(src.read_text() + "// edited\n")
    assert [k for k in names if paths()[k] != edited[k]] == ["alt_corr"]
    # through a header that includes another
    (csrc / "outer.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// v1\n")
    (csrc / "probe.cu").write_text('#include "outer.cuh"\n')
    first = _build._lib_path("probe")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert _build._lib_path("probe") != first
