"""The port's replica fleet on the CPU beyond the JAX router's own cases
(``tests/test_torch_port_fleet.py`` has those): ``serve_fleet``'s refusals
and its CLI end to end with video sessions pinned; a worker asked for the
card without one failing its spawn, with no fallback; and MADNet2 against
the JAX package: two CPU workers restore a port checkpoint of the
variables the JAX ``serve_fleet.build_engine`` MADNet2 engine serves
(``init`` under PRNGKey(0) on a RandomState(0) image, carried by
``state_dict_from_jax``) and serve 4 pairs at 128×256; each payload is held
to that JAX engine's output on the same pair, run in this process, within
1e-4·max|JAX| + 1e-5 px (the disparities are ×−20 pixels), as
``tests/test_torch_port_mad_cli.py`` holds the port's MADNet2 engine to the
JAX one. Workers get one intra-op thread and the router's spawn timeout,
so a stuck worker fails its test instead of hanging the suite.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from raft_stereo_tpu import serve_fleet as jax_serve_fleet
from raft_stereo_tpu.runtime import infer as jinfer
from raft_stereo_tpu_torch import serve_fleet
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.fleet import FleetRouter
from raft_stereo_tpu_torch.runtime.infer import InferRequest
from raft_stereo_tpu_torch.utils.checkpoints import save_train_state
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

TOY_KW = {"model": "toy", "device": "cpu", "batch": 2, "infer_timeout": 6.0,
          "retries": 1, "warm": False}
OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
MAD_SIZE = (128, 256)
# the workers share the machine's cores with the other test workers
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SPAWN_TIMEOUT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    yield t
    telemetry.uninstall(t)


def _events(tmp_path, name):
    path = tmp_path / "tel" / "events.jsonl"
    evs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return [e for e in evs if e.get("event") == name]


def _router(tmp_path, n_hosts=2, factory_kw=None, **kw):
    return FleetRouter(serve_fleet.FACTORY, n_hosts,
                       factory_kw=dict(TOY_KW, **(factory_kw or {})),
                       workdir=str(tmp_path / "fleet"), spawn_timeout_s=SPAWN_TIMEOUT_S,
                       env=WORKER_ENV, **kw)


@pytest.mark.parametrize("argv, match", [
    (["--cascade"], "--cascade composes inside a worker"),
    (["--adaptive_iters"], "--adaptive_iters composes inside a worker"),
    (["--tier", "fast"], "--tier composes inside a worker"),
    (["--spatial_threshold", "5000"], r"workers serve MADNet2 \(no spatial tier\)"),
], ids=["cascade", "adaptive_iters", "tier", "spatial_threshold"])
def test_cli_refusals(argv, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        serve_fleet.main(["--model", "toy"] + argv, device="cpu")
    assert not (tmp_path / "runs").exists()  # refused before anything starts


def test_cli_aot_dir_second_fleet_prewarms_every_worker(tmp_path, monkeypatch):
    """``serve_fleet --aot_dir`` with two CPU workers, run twice on one
    store: the first fleet compiles and commits its key; each worker of the
    second logs ``aot_store_hit`` for it (while its engine is built, before
    it reports healthy) and no ``bucket_compile``; both runs serve every
    request."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(FleetRouter, "__init__", _with_test_spawn(FleetRouter.__init__))
    argv = ["--model", "toy", "--num_requests", "8", "--synthetic_size", "32", "64",
            "--sched_max_wait", "0.1", "--aot_dir", "aot"]
    events = {}
    for name in ("cold", "warm"):
        summary = serve_fleet.main(argv + ["--name", name], device="cpu")
        assert summary["served"] == 8 and summary["failed"] == 0
        events[name] = {
            p.parent.name: [json.loads(x)["event"] for x in p.read_text().splitlines()]
            for p in (tmp_path / "runs" / name / "fleet").glob("host*/events.jsonl")}
    assert sorted(events["warm"]) == ["host0", "host1"]
    assert sum(ev.count("bucket_compile") for ev in events["cold"].values()) >= 1
    for host, ev in events["warm"].items():
        assert ev.count("aot_store_hit") == 1 and "bucket_compile" not in ev, (host, ev)


def test_cli_serves_video_sessions_pinned(tmp_path, monkeypatch):
    """``serve_fleet --model toy --source video`` end to end on the CPU:
    every request served once, each session on one host, the router's
    events in its telemetry directory, the last stdout line the summary."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(FleetRouter, "__init__", _with_test_spawn(FleetRouter.__init__))
    summary = serve_fleet.main(["--model", "toy", "--source", "video", "--video_sessions",
                                "2", "--num_requests", "8", "--synthetic_size", "32", "64",
                                "--sched_max_wait", "0.1"], device="cpu")
    assert summary["served"] == 8 and summary["failed"] == 0
    assert summary["failovers"] == summary["fenced"] == summary["typed_losses"] == 0
    assert summary["pairs_per_s"] > 0 and summary["sessions"] == 2
    evs = [json.loads(line) for line in
           (tmp_path / "runs" / "serve-fleet" / "events.jsonl").read_text().splitlines()]
    routes = [e for e in evs if e["event"] == "fleet_route"]
    by_session = {}
    for e in routes:
        by_session.setdefault(e["session"], set()).add(e["host"])
    assert len(routes) == 8 and sorted(by_session) == ["video0", "video1"]
    assert all(len(hosts) == 1 for hosts in by_session.values())
    assert not [e for e in evs if e["event"] == "fleet_host_down"]


def _with_test_spawn(init):
    def wrapped(self, *a, **kw):
        kw.setdefault("env", WORKER_ENV)
        kw.setdefault("spawn_timeout_s", SPAWN_TIMEOUT_S)
        init(self, *a, **kw)
    return wrapped


def test_a_worker_asked_for_the_card_without_one_fails_its_spawn(tmp_path, tel):
    """No fallback: a worker built for ``cuda`` on a machine without a card
    raises, the spawn fails with the worker's error in its log, and
    nothing serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    router = _router(tmp_path, n_hosts=2, factory_kw={"device": "cuda"})
    with pytest.raises(RuntimeError, match="died during spawn") as exc:
        router.start()
    assert "no CUDA device" in str(exc.value)
    for h in router._hosts:
        assert h.sock is None and h.state == "spawning"
    alive = [t.name for t in threading.enumerate() if t.name.startswith("fleet-")]
    assert alive == []
    logs = sorted((tmp_path / "fleet").glob("host*.1.log"))
    assert logs and any("no CUDA device" in p.read_text() for p in logs)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_madnet2_fleet_matches_the_jax_engine(tmp_path, tel):
    """Both CPU workers serve; every payload within the tolerance of the
    JAX engine's (module docstring), each resolved once, no failover."""
    jengine = jax_serve_fleet.build_engine({"model": "madnet2", "batch": 2})
    ckpt = tmp_path / "madnet2_jax"
    save_train_state(str(ckpt), state_dict_from_jax(_np(jengine._variables)))
    rng = np.random.RandomState(0)
    pairs = [tuple((rng.rand(*MAD_SIZE, 3) * 255).astype(np.float32) for _ in range(2))
             for _ in range(4)]
    want = {r.payload: r.output for r in jengine.stream(iter(
        [jinfer.InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs)]))}
    kw = {"model": "madnet2", "device": "cpu", "batch": 2, "infer_timeout": 120.0,
          "retries": 1, "restore_ckpt": str(ckpt)}
    with FleetRouter(serve_fleet.FACTORY, 2, factory_kw=kw, workdir=str(tmp_path / "fleet"),
                     max_wait_s=0.1, spawn_timeout_s=SPAWN_TIMEOUT_S, down_after_s=30.0,
                     env=WORKER_ENV) as router:
        got = list(router.serve(iter([InferRequest(payload=i, inputs=p)
                                      for i, p in enumerate(pairs)])))
        snap = router.snapshot()
    assert sorted(r.payload for r in got) == [0, 1, 2, 3]
    assert snap["failovers"] == snap["fenced"] == snap["typed_losses"] == 0
    assert {e["host"] for e in _events(tmp_path, "fleet_route")} == {0, 1}
    for r in got:
        assert r.ok, r.error
        assert r.output.shape == want[r.payload].shape == (*MAD_SIZE, 1)
        err = float(np.abs(r.output - want[r.payload]).max())
        assert err <= OUT_RTOL * float(np.abs(want[r.payload]).max()) + OUT_ATOL
