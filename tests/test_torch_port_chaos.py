"""The port's chaos campaign (``raft_stereo_tpu_torch/tools/chaos.py``)
held to the JAX tool (``tools/chaos.py``), whose spec generation,
invariant checkers and minimizer are pure and run here without JAX.

* Spec parity: the port's ``make_spec`` equals the JAX one for seeds 0-59,
  at the default cadences and others, with ``violate`` both ways.
* Checker parity: every fabricated case that ``tests/test_chaos.py``'s
  ``TestInvariantCheckers`` and ``tests/test_introspection.py``'s chaos
  cases hand the JAX ``check_invariants`` gives the same violations from the
  port's; ``TestMinimizer``'s two cases on the port's minimizer; the two
  packages' event schemas and reserved keys equal.
* End to end on the CPU (``device="cpu"``): seeds 0 (sched), 4 (cascade),
  6 (video) and 10 (quality) pass every invariant, and the planted
  violation of seed 1 is caught and minimized to the one planted entry.
  The faults the campaign found in the port are pinned: seed 10 (a
  ``SessionServer`` whose first warm frame imported scipy on the decode
  thread), seed 24's minimal schedule (a failed capture of an OOM-halved
  key, neither retried nor told from the OOM), seed 44's (the cascade's
  quality tier taking an idle escalation feed for a stall) and, as a
  deterministic case, seed 48's (a request stranded when its batchmate's
  decode failed).
* ``slow``, as the JAX campaign test: 20 seeds, all seven modes.
* On the card: ``tests/test_torch_port_cuda.py::
  test_chaos_seed_green_on_the_card`` (this file imports the JAX tool's
  tests).

Budget: about 70 s of this file alone on one worker, most of it the
children (each imports torch, about 3 s).
"""

import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import test_chaos as jax_chaos_tests
import test_introspection as jax_introspection_tests
from raft_stereo_tpu.runtime import telemetry as jax_telemetry
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.tools import chaos
from tools import chaos as jax_chaos

REPO = Path(__file__).resolve().parent.parent

# ----------------------------------------------------------- spec parity

CADENCES = [
    {},
    {"adaptive_every": 0, "cascade_every": 0},
    {"video_every": 3, "ctrl_every": 4, "quality_every": 5, "fleet_every": 0},
    {"fleet_every": 1},
]


@pytest.mark.parametrize("violate", [False, True])
@pytest.mark.parametrize("cadence", range(len(CADENCES)))
def test_make_spec_equals_the_jax_spec(cadence, violate):
    kw = CADENCES[cadence]
    for seed in range(60):
        assert chaos.make_spec(seed, violate=violate, **kw) == \
            jax_chaos.make_spec(seed, violate=violate, **kw), seed


def test_default_cadences_give_the_card_phase_its_modes():
    """The seeds the card runs, one of each mode."""
    modes = {s: chaos.make_spec(s)["mode"] for s in (0, 4, 6, 8, 9, 10, 12)}
    assert modes == {0: "sched", 4: "cascade", 6: "video", 8: "ctrl", 9: "adaptive",
                     10: "quality", 12: "fleet"}
    assert {e["kind"] for s in (1, 2) for e in chaos.make_spec(s)["schedule"]} == \
        {"sigterm", "compile_fail", "decode_fail"}


def test_schema_and_reserved_keys_equal_the_jax_ones():
    assert telemetry.EVENT_SCHEMA == jax_telemetry.EVENT_SCHEMA
    assert set(telemetry.RESERVED_KEYS) == set(jax_telemetry.RESERVED_KEYS)


# -------------------------------------------------------- checker parity

CHECKER_CASES = (
    [("TestInvariantCheckers", name) for name, _ in inspect.getmembers(
        jax_chaos_tests.TestInvariantCheckers, inspect.isfunction) if name.startswith("test_")]
    + [("introspection", "test_chaos_blackbox_invariant_both_ways"),
       ("introspection", "test_chaos_thread_leak_and_healthz_invariants")])


@pytest.mark.parametrize("where,name", CHECKER_CASES)
def test_checkers_give_the_jax_violations(where, name, monkeypatch, tmp_path):
    """Runs the JAX test case with the JAX ``check_invariants`` recorded,
    then each recorded call on the port's checker."""
    calls = []
    jax_check = jax_chaos.check_invariants

    def recorded(*args):
        want = jax_check(*args)
        calls.append((chaos.check_invariants(*args), want))
        return want

    monkeypatch.setattr(jax_chaos, "check_invariants", recorded)
    if where == "TestInvariantCheckers":
        getattr(jax_chaos_tests.TestInvariantCheckers(), name)()
    else:
        getattr(jax_introspection_tests, name)(tmp_path)
    assert calls
    for got, want in calls:
        assert got == want


@pytest.mark.parametrize("name", ["test_greedy_ddmin_isolates_the_culprit",
                                  "test_irreducible_schedule_survives"])
def test_minimizer_cases_on_the_port(name, monkeypatch):
    monkeypatch.setattr(jax_chaos_tests, "chaos", chaos)
    getattr(jax_chaos_tests.TestMinimizer(), name)()


def test_importing_the_tool_loads_no_jax_and_no_root_tools():
    code = ("import sys; import raft_stereo_tpu_torch.tools.chaos; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'cv2', 'raft_stereo_tpu', 'tools')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_session_server_imports_the_warm_fill_when_built():
    """The fault seed 10 found: the default warm fill's first call imported
    scipy on the decode thread (1.7 s on the CPU), while the paced source
    ran ahead, so the canaries dispatched before the plant. A server that
    warm-starts now imports it when it is built."""
    code = ("import sys; from raft_stereo_tpu_torch.runtime.scheduler import SessionServer; "
            "assert 'scipy.interpolate' not in sys.modules; "
            "SessionServer(lambda requests: iter(()), warm_start=False); "
            "assert 'scipy.interpolate' not in sys.modules; "
            "SessionServer(lambda requests: iter(())); "
            "assert 'scipy.interpolate' in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------ end to end, CPU

# seed 10 at the default cadences: the quality trial whose canary latch took
# 17 user results against a budget of 16 before the fix (the JAX tool, 21)
QUALITY_SWAP_SPEC = {
    "seed": 10, "mode": "quality", "plant": "swap", "plant_at": 23, "n_requests": 56,
    "n_sessions": 2, "batch": 2, "pace_s": 0.05, "max_wait_s": 0.05, "infer_timeout": 6.0,
    "retries": 1, "drain_timeout": 8.0,
    "quality": {"window_n": 6, "reference_n": 12, "canary_every": 4, "canary_latch": 2,
                "canary_tol": 0.5},
    "detect_within": 16, "schedule": [],
}


# seed 24's schedule minimized on the parent tree, where it failed two
# requests with an injected compile failure: the capture of the halved key
# that an OOM asked for ran unretried, inside the OOM's handler, so the
# failure carried the OOM as its context and passed for one
HALVED_COMPILE_SPEC = {
    "seed": 24, "mode": "cascade", "n_requests": 13,
    "shapes": [0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1],
    "deadlines": {"9": 2.0, "2": 0.79, "3": 1.51}, "batch": 2, "max_wait_s": 0.2,
    "max_pending": 6, "infer_timeout": 2.0, "retries": 1, "drain_timeout": 5.0,
    "schedule": [{"kind": "compile_fail", "ordinals": [3]}, {"kind": "oom", "threshold": 2}],
    "escalate": [1, 4, 11],
}


def test_a_halved_keys_failed_compile_is_retried(tmp_path):
    assert dict(chaos.make_spec(24), schedule=HALVED_COMPILE_SPEC["schedule"]) == \
        HALVED_COMPILE_SPEC
    violations, rc = chaos.run_trial(HALVED_COMPILE_SPEC, str(tmp_path), device="cpu")
    assert rc == 0 and violations == [], violations
    events = [json.loads(line) for p in tmp_path.glob("tel_*/events.jsonl")
              for line in p.read_text().splitlines()]
    assert any(e["event"] == "infer_retry" and e["kind"] == "compile" for e in events)
    assert any(e["event"] == "infer_degraded" and e["reason"] == "oom" for e in events)


# seed 44's schedule minimized on the parent tree, where the child died: a
# hang on the fast tier's first device wait held the escalation feed idle
# for the fast tier's 2 s deadline, and the quality tier's idle watchdog
# took that for a stalled stager (InferStallError out of the cascade)
IDLE_ESCALATION_SPEC = {
    "seed": 44, "mode": "cascade", "n_requests": 11,
    "shapes": [0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1], "deadlines": {}, "batch": 2,
    "max_wait_s": 0.2, "max_pending": 11, "infer_timeout": 2.0, "retries": 1,
    "drain_timeout": 5.0, "schedule": [{"kind": "hang", "ordinals": [1]}],
    "escalate": [1, 2, 4, 9, 10],
}


def test_an_idle_escalation_feed_is_no_stall(tmp_path):
    assert dict(chaos.make_spec(44), schedule=IDLE_ESCALATION_SPEC["schedule"]) == \
        IDLE_ESCALATION_SPEC
    violations, rc = chaos.run_trial(IDLE_ESCALATION_SPEC, str(tmp_path), device="cpu")
    assert rc == 0 and violations == [], violations


def test_a_failed_decode_in_a_full_group_strands_no_batchmate():
    """Seed 48 (video) died under load when the decode failure it arms hit
    one of a full scheduler group's two requests: the other sat in the
    engine's bucket short of a batch, no flush followed, and its session's
    next frame waited on its result until the stager watchdog tripped. The
    same here, deterministically: the source's third request waits on the
    first's result."""
    import threading

    import numpy as np

    from raft_stereo_tpu_torch.runtime import faultinject
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler

    def fn(a, b):
        return (a * 2.0 - b).sum(-1, keepdim=True)

    engine = InferenceEngine(fn, device="cpu", batch=2, deadline_s=2.0, retries=1,
                             eager_finalize=True)
    sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
    rng = np.random.RandomState(0)
    first_done = threading.Event()

    def req(i):
        return InferRequest(payload=i, inputs=tuple(rng.rand(24, 48, 3).astype(np.float32)
                                                    for _ in range(2)))

    def source():
        yield req(0)
        yield req(1)
        first_done.wait(10)
        yield req(2)

    faultinject.reset()
    chaos._arm_schedule([{"kind": "decode_fail", "ordinals": [2]}])
    try:
        out = {}
        for r in sched.serve(source()):
            out[r.payload] = r
            if r.payload == 0:
                first_done.set()
    finally:
        faultinject.reset()
    assert sorted(out) == [0, 1, 2]
    assert out[0].ok and out[2].ok and type(out[1].error).__name__ == "OSError"


@pytest.mark.parametrize("seed", [0, 4, 6, 10])
def test_seed_green_on_the_cpu(seed, tmp_path):
    spec = chaos.make_spec(seed)
    if seed == 10:
        assert spec == QUALITY_SWAP_SPEC
        spec = QUALITY_SWAP_SPEC
    violations, rc = chaos.run_trial(spec, str(tmp_path), device="cpu")
    assert rc == 0 and violations == [], violations
    report = json.loads(next(tmp_path.glob("report_*.json")).read_text())
    assert report["spec"]["device"] == "cpu"
    assert sum(report["launches"]["counted"].values()) == 0  # the toy runs no kernel


def test_planted_violation_caught_and_minimized(tmp_path):
    summary = chaos.run_campaign([1], str(tmp_path), violate=True, adaptive_every=0,
                                 device="cpu")
    assert not summary["ok"] and len(summary["failed"]) == 1
    entry = summary["failed"][0]
    assert any("resolve_exactly_once" in v for v in entry["violations"])
    assert entry["minimal_schedule"] == [{"kind": "violate_drop_result"}]
    assert "--repro" in entry["repro"] and '"device": "cpu"' in entry["repro"]
    doc = json.loads((tmp_path / "chaos.json").read_text())
    assert doc["failed"][0]["seed"] == 1
    # the root run report renders the port's chaos.json as the JAX tool's
    from tools import run_report

    assert run_report.build_report(str(tmp_path))["chaos"] == run_report.summarize_chaos(doc)
    assert run_report.summarize_chaos(doc)["ok"] is False


def test_a_child_asked_for_the_card_without_one_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    violations, rc = chaos.run_trial(chaos.make_spec(0), str(tmp_path), device="cuda")
    assert rc != 0 and any("no CUDA device" in v for v in violations), violations


@pytest.mark.slow
def test_campaign_twenty_seeds_green(tmp_path):
    """20 seeds, every mode among them, pass every invariant on the CPU."""
    summary = chaos.run_campaign(list(range(20)), str(tmp_path), minimize=False,
                                 device="cpu")
    assert summary["ok"], summary["failed"]
    assert summary["passed"] == 20
    modes = {t["mode"] for t in summary["trials"]}
    assert modes == {"sched", "adaptive", "cascade", "video", "ctrl", "quality", "fleet"}
