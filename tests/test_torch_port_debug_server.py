"""The port's introspection server on the CPU
(``raft_stereo_tpu_torch/runtime/debug_server.py``): the two debug-server
cases of ``tests/test_introspection.py``, under their names; the port's
bodies against the JAX server's for the same providers and events; and
``serve_adaptive --debug_port 0`` answering every endpoint while it serves
a cascade under the overload controller, the bound port read back from
the line the CLI prints. Every request goes to 127.0.0.1.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from raft_stereo_tpu.runtime import blackbox as jblackbox
from raft_stereo_tpu.runtime import telemetry as jtelemetry
from raft_stereo_tpu.runtime.debug_server import DebugServer as JaxDebugServer
from raft_stereo_tpu_torch.runtime import blackbox, telemetry
from raft_stereo_tpu_torch.runtime.debug_server import DebugServer


@pytest.fixture
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "run"), ring_capacity=64))
    yield t
    telemetry.uninstall(t)


@pytest.fixture
def dumper(tel):
    d = blackbox.install(blackbox.BlackboxDumper(tel.run_dir))
    yield d
    blackbox.uninstall(d)


def _emit_n(module, n, start=0):
    for i in range(start, start + n):
        module.emit("sched_admit", bucket=[32, 64], depth=i, priority=0, deadline_ms=None,
                    trace_id=f"t{i}")


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type", "")


def test_debug_server_endpoints(tel, dumper):
    _emit_n(telemetry, 3)
    dumper.register("scheduler", lambda: {
        "depth": 1, "draining": False,
        "buckets": {"32x64": {"pending": 1, "oldest_wait_s": 0.1}},
    })
    srv = DebugServer(0).start()
    try:
        h = json.loads(_get(srv.port, "/healthz")[0])
        assert h["ok"] and h["status"] == "serving"
        assert "scheduler" in h["providers"]
        q = json.loads(_get(srv.port, "/debug/queues")[0])
        assert q["scheduler"]["buckets"]["32x64"]["pending"] == 1
        st = json.loads(_get(srv.port, "/debug/stacks")[0])
        assert any(t["role"] == "introspect" for t in st["threads"])
        rq = json.loads(_get(srv.port, "/debug/requests/t1")[0])
        assert len(rq["events"]) == 1
        _, ctype = _get(srv.port, "/metrics")
        assert ctype.startswith("text/plain")
        with pytest.raises(urllib.error.HTTPError) as e404:
            _get(srv.port, "/debug/requests/nope")
        assert e404.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e404b:
            _get(srv.port, "/no/such")
        assert e404b.value.code == 404
    finally:
        srv.close()
    assert "debug-server" not in [t.name for t in threading.enumerate()]


def test_debug_server_healthz_reflects_drain_and_frozen(tel, dumper):
    dumper.register("scheduler", lambda: {"depth": 0, "draining": True, "buckets": {}})
    dumper.register("adapt", lambda: {"frozen": True})
    srv = DebugServer(0).start()
    try:
        h = json.loads(_get(srv.port, "/healthz")[0])
        assert h["draining"] and h["frozen"] and h["status"] == "frozen"
    finally:
        srv.close()


def _normalise(path, body):
    doc = json.loads(body)
    if path.split("?")[0].rstrip("/") == "/healthz":
        doc.pop("uptime_s")
    for e in doc.get("events", []) if path.startswith("/debug/requests/") else []:
        for k in ("t_wall", "t_mono", "host"):
            e.pop(k, None)
    return doc


def test_debug_server_renders_as_the_jax_one(tmp_path):
    """The same providers (a scheduler, a raising one, a cascade, an
    adaptive server draining) and the same events through the port's and
    the JAX server's ``render``: the same status and the same JSON for
    every path but the uptime and the events' clocks, and both serve their
    registry's Prometheus text."""
    providers = [
        ("scheduler", lambda: {"depth": 2, "draining": True,
                               "buckets": {"32x64": {"pending": 2}}}),
        ("engine:quality", lambda: {"broken_buckets": {"32x64": "compile"}}),
        ("cascade", lambda: {"stats": {"accepted": 3}}),
        ("tiered", lambda: 1 / 0),
        ("adapt", lambda: {"frozen": False}),
    ]
    paths = ["/healthz", "/debug/queues", "/debug/snapshots", "/debug/requests/t2",
             "/debug/requests/none", "/debug/quality", "/nope", "/healthz/?x=1"]
    out = {}
    for name, tel_mod, bb_mod, server_cls in (
            ("port", telemetry, blackbox, DebugServer),
            ("jax", jtelemetry, jblackbox, JaxDebugServer)):
        t = tel_mod.install(tel_mod.Telemetry(str(tmp_path / name), ring_capacity=64))
        d = bb_mod.install(bb_mod.BlackboxDumper(t.run_dir))
        try:
            _emit_n(tel_mod, 4)
            for kind, fn in providers:
                d.register(kind, fn)
            srv = server_cls(0, dumper=d)
            try:
                out[name] = {p: srv.render(p) for p in paths}
                out[name]["/metrics"] = srv.render("/metrics")
            finally:
                srv.close()
        finally:
            bb_mod.uninstall(d)
            tel_mod.uninstall(t)
    for p in paths:
        body, status, ctype = out["port"][p]
        jbody, jstatus, jctype = out["jax"][p]
        assert (status, ctype) == (jstatus, jctype), p
        assert _normalise(p, body) == _normalise(p, jbody), p
    assert out["port"]["/metrics"][1] == out["jax"]["/metrics"][1] == 200


def test_serve_adaptive_debug_port_answers_while_serving(tmp_path, monkeypatch, capsys):
    """``serve_adaptive --cascade --sched --controller --debug_port 0
    --telemetry_dir``: between two chunks of the serve the source reads the
    bound port from the CLI's line and GETs every endpoint; each answers 200
    and names the controller, the tiered providers and the adaptive server."""
    from raft_stereo_tpu_torch import serve_adaptive

    monkeypatch.chdir(tmp_path)
    inner = serve_adaptive.request_stream
    seen = {}

    def probing(args):
        for i, req in enumerate(inner(args)):
            if i == 2:  # the first chunk has been served
                port = int(re.search(r"introspection server on http://127\.0\.0\.1:(\d+)",
                                     capsys.readouterr().out).group(1))
                for path in ("/healthz", "/debug/queues", "/debug/snapshots",
                             "/debug/stacks", "/debug/quality", "/metrics"):
                    body, _ = _get(port, path)
                    seen[path] = body if path == "/metrics" else json.loads(body)
            yield req

    monkeypatch.setattr(serve_adaptive, "request_stream", probing)
    res = serve_adaptive.main([
        "--name", "dbg", "--source", "synthetic", "--synthetic_size", "64", "96",
        "--num_requests", "4", "--no_adapt", "--infer_batch", "2", "--adapt_every", "2",
        "--cascade", "--cascade_threshold=-1", "--quality_iters", "1", "--sched",
        "--controller", "--slo_p95_ms", "10000", "--debug_port", "0",
        "--telemetry_dir", str(tmp_path / "tel")], device="cpu")
    assert res["served"] == 4 and res["failed"] == 0
    providers = seen["/healthz"]["providers"]
    assert seen["/healthz"]["status"] == "serving" and seen["/healthz"]["telemetry"]
    assert {"controller", "cascade", "adapt", "engine:fast", "engine:quality",
            "scheduler:fast", "scheduler:quality"} <= {p.split("#")[0] for p in providers}
    assert {"cascade", "scheduler:fast", "scheduler:quality"} <= \
        {k.split("#")[0] for k in seen["/debug/queues"]}
    snaps = seen["/debug/snapshots"]
    ctrl = next(v for k, v in snaps.items() if k.split("#")[0] == "controller")
    assert ctrl["armed"] and [r["name"] for r in ctrl["ladder"]] == \
        ["cascade_bar", "adapt_pause"]
    assert any(t["name"] == "overload-ctrl" for t in seen["/debug/stacks"]["threads"])
    assert "fast" in seen["/debug/quality"]["tiers"]
    assert b"slo_" in seen["/metrics"]
    assert "debug-server" not in [t.name for t in threading.enumerate()]
