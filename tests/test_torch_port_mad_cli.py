"""The MADNet2 family's serving engine, train step and CLIs of the port
(``evaluate_mad.py``, ``train_mad.py``, ``serve_adaptive.py``, the engine's
``divis_by``) on the CPU, against the JAX package where it has a
counterpart.

Weights are the JAX package's (MADNet2 at PRNGKey(0)), carried by
``state_dict_from_jax``; the CLIs take them as a reference-style ``.pth``
through ``--restore_ckpt``. Tolerances: served disparities (×−20 pixels)
within 1e-4·max|JAX| + 1e-5 px; FlyingThings EPE within 1e-5 relative and
bad-1.0 within 1e-6 (percent); a train step's loss and metrics within 1e-5
relative, its Adam moments within 1e-3 of each tensor's largest (the
gradients themselves), its weights within 1e-6 of optax's where the step's
first moment is above rounding (the Adam-sign argument of
``tests/test_torch_port_adapt.py``) and within the step's size elsewhere.
"""

import argparse
import json
import os
import os.path as osp
import threading

import fixture_trees as ft
import jax
import numpy as np
import pytest
import torch

from raft_stereo_tpu import evaluate_mad as jax_evaluate_mad
from raft_stereo_tpu import train_mad as jax_train_mad
from raft_stereo_tpu.models import MADNet2 as JaxMADNet2
from raft_stereo_tpu.models import MADNet2Fusion as JaxMADNet2Fusion
from raft_stereo_tpu.models.madnet2 import MADController as JaxMADController
from raft_stereo_tpu.parallel import create_train_state
from raft_stereo_tpu.runtime import adapt as jadapt
from raft_stereo_tpu.runtime import infer as jinfer
from raft_stereo_tpu_torch import evaluate_mad, serve_adaptive, train_mad
from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
from raft_stereo_tpu_torch.ops import pad
from raft_stereo_tpu_torch.parallel.train_step import TrainState
from raft_stereo_tpu_torch.runtime.infer import InferOptions, InferRequest
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
EPE_RTOL, D1_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
PARAM_ATOL, ILL_COND = 1e-6, 1e-2
# a train step's Adam moments against optax's, per tensor, of its largest
# value: the worst readings were 4.1e-6 (mad, mad2) and 2.2e-4 (fusion,
# decoder2 behind the attention) of the tensor's largest moment
MOMENT_RTOL, MOMENT_ATOL = 1e-3, 1e-12
# two buckets at /128: (128, 128) x4 with a partial batch, (256, 128) x1
MIXED = [(64, 96), (100, 120), (64, 96), (130, 100), (64, 96)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_vars():
    im = np.zeros((1, 128, 128, 3), np.float32)
    return _np(jax.jit(JaxMADNet2().init)(jax.random.PRNGKey(0), im, im))


@pytest.fixture(scope="module")
def jax_fusion_vars():
    im = np.zeros((1, 128, 128, 3), np.float32)
    g = np.zeros((1, 128, 128, 1), np.float32)
    return _np(jax.jit(JaxMADNet2Fusion().init)(jax.random.PRNGKey(0), im, im, g))


@pytest.fixture(scope="module")
def pth(jax_vars, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "madnet2.pth"
    torch.save({f"module.{k}": v for k, v in state_dict_from_jax(jax_vars).items()}, path)
    return str(path)


def _pairs(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [tuple((rng.rand(h, w, 3) * 255).astype(np.float32) for _ in range(2))
            for h, w in shapes]


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("batch", [2, 1], ids=["batched", "per_image"])
def test_mad_engine_matches_the_jax_engine(jax_vars, batch):
    """÷128 buckets, each item padded with its own offsets, bilinear ×4 and
    ×−20 inside the forward: every payload against the JAX engine's."""
    pairs = _pairs(MIXED)
    jengine = jax_evaluate_mad.make_mad_engine(
        JaxMADNet2(), jax_vars, infer=jinfer.InferOptions(batch=batch, prefetch=1))
    want = {r.payload: r.output for r in jengine.stream(
        iter([jinfer.InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs)]))}
    model = make_madnet2()
    model.load_state_dict(state_dict_from_jax(jax_vars), strict=True)
    engine = evaluate_mad.make_mad_engine(model, infer=InferOptions(batch=batch, prefetch=1))
    assert engine.divis_by == 128 and not engine.capture
    got = list(engine.stream(iter([InferRequest(payload=i, inputs=p)
                                   for i, p in enumerate(pairs)])))
    assert sorted(r.payload for r in got) == list(range(len(MIXED)))
    for r in got:
        h, w = MIXED[r.payload]
        assert r.ok and r.output.shape == (h, w, 1)
        assert r.bucket == pad.bucket_shape(h, w, 128)
        err = float(np.abs(r.output - want[r.payload]).max())
        assert err <= OUT_RTOL * float(np.abs(want[r.payload]).max()) + OUT_ATOL
    assert engine.stats.buckets == jengine.stats.buckets == {(128, 128): 4, (256, 128): 1}
    assert engine.stats.padded_slots == jengine.stats.padded_slots


def test_default_divisor_keeps_the_raft_buckets():
    """``divis_by`` defaults to 32: the stager's buckets, the batch padder
    and the graph keys of an engine built without it are the /32 ones."""
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine

    seen = []

    def fwd(a, b):
        seen.append(tuple(a.shape))
        return a[..., :1] - b[..., :1]

    eng = InferenceEngine(fwd, device="cpu", batch=2)
    assert eng.divis_by == 32
    out = list(eng.stream(iter([InferRequest(payload=i, inputs=p)
                                for i, p in enumerate(_pairs([(40, 72), (40, 72)]))])))
    assert [r.bucket for r in out] == [(64, 96)] * 2 and seen == [(2, 64, 96, 3)]
    assert eng._key((64, 96), [np.zeros((2, 64, 96, 3), np.float32)] * 2)[0] == (64, 96)


# ------------------------------------------------------------ train steps


@pytest.mark.parametrize("variant", ["mad", "mad2", "fusion"])
def test_mad_train_step_matches_jax(jax_vars, jax_fusion_vars, variant):
    fusion = variant == "fusion"
    args = argparse.Namespace(variant=variant, lr=1e-4, wdecay=1e-5)
    variables = jax_fusion_vars if fusion else jax_vars
    tx, _ = jax_train_mad.fetch_mad_optimizer(args)
    jmodel = JaxMADNet2Fusion() if fusion else JaxMADNet2()
    jstate = create_train_state(variables, tx)
    rng = np.random.RandomState(1)
    batch = {"img1": (rng.rand(2, 64, 128, 3) * 255).astype(np.float32),
             "img2": (rng.rand(2, 64, 128, 3) * 255).astype(np.float32),
             "flow": (rng.rand(2, 64, 128, 1) * 30).astype(np.float32),
             "valid": (rng.rand(2, 64, 128) > 0.2).astype(np.float32)}
    if fusion:
        batch["guide"] = batch["flow"]
    jstate, jmetrics = jax_train_mad.make_mad_train_step(jmodel, tx, variant, fusion)(
        jstate, batch)
    model = make_madnet2(fusion=fusion)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt, sched, _ = train_mad.fetch_mad_optimizer(args, list(model.parameters()))
    state = TrainState(model.train(), opt, sched)
    state, metrics = train_mad.make_mad_train_step(variant, fusion)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    want = state_dict_from_jax({"params": _np(jstate.params)})
    adam = jstate.opt_state[2][0]
    mu = state_dict_from_jax({"params": _np(adam.mu)})
    nu = state_dict_from_jax({"params": _np(adam.nu)})
    for n, p in model.named_parameters():
        # the moments hold the clipped, decayed gradient itself (g and g²
        # scaled), which the parameters after one step show only by sign
        st = opt.state[p]
        for got, ref in ((st["exp_avg"], mu[n]), (st["exp_avg_sq"], nu[n])):
            err = float((got - ref).abs().max())
            assert err <= MOMENT_RTOL * float(ref.abs().max()) + MOMENT_ATOL, (n, err)
        diff = (p.detach() - want[n]).abs()
        noisy = mu[n].abs() <= ILL_COND * mu[n].abs().max()
        assert bool((diff[~noisy] <= PARAM_ATOL).all()), (n, float(diff[~noisy].max()))
        assert float(diff.max()) <= 2 * 1e-4, n


# --------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def things_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("things")
    ft.build_sceneflow_test_readable(str(root), n=3)
    return root


@pytest.mark.parametrize("mode", ["engine", "per_image", "fusion"])
def test_evaluate_mad_main_matches_jax(things_tree, jax_vars, jax_fusion_vars, pth, mode,
                                       monkeypatch, tmp_path):
    monkeypatch.chdir(things_tree)
    fusion = mode == "fusion"
    jmodel = JaxMADNet2Fusion() if fusion else JaxMADNet2()
    want = jax_evaluate_mad.validate_things_mad(
        jmodel, jax_fusion_vars if fusion else jax_vars, fusion=fusion,
        log_dir=str(tmp_path / "jax"), infer=jinfer.InferOptions(batch=2))
    argv = ["--infer_batch", "2"]
    if fusion:
        weights = tmp_path / "fusion.pth"
        torch.save(state_dict_from_jax(jax_fusion_vars), weights)
        argv += ["--fusion", "--restore_ckpt", str(weights)]
    else:
        argv += ["--restore_ckpt", pth] + (["--per_image"] if mode == "per_image" else [])
    log = things_tree / "runs" / "log.txt"
    lines = open(log).read().count("\n") if log.exists() else 0
    got = evaluate_mad.main(argv, device="cpu")
    assert sorted(got) == sorted(want) == ["things-d1", "things-epe", "things-nans"]
    np.testing.assert_allclose(got["things-epe"], want["things-epe"], rtol=EPE_RTOL)
    np.testing.assert_allclose(got["things-d1"], want["things-d1"], rtol=0, atol=D1_ATOL)
    assert got["things-nans"] == want["things-nans"] == 0
    assert open(log).read().count("\n") == lines + 1  # the reference's log line
    engine = evaluate_mad.last_engine()
    assert engine.divis_by == 128 and engine.stats.images == 3
    assert engine.batch == (1 if mode == "per_image" else 2)


def test_evaluate_mad_reads_a_port_checkpoint(things_tree, jax_vars, pth, monkeypatch,
                                              tmp_path):
    from raft_stereo_tpu_torch.utils.checkpoints import save_train_state

    monkeypatch.chdir(things_tree)
    save_train_state(str(tmp_path / "ckpt"), {"model": state_dict_from_jax(jax_vars)})
    a = evaluate_mad.main(["--restore_ckpt", pth, "--infer_batch", "2"], device="cpu")
    b = evaluate_mad.main(["--restore_ckpt", str(tmp_path / "ckpt"), "--infer_batch", "2"],
                          device="cpu")
    assert a == b


def _jax_summary_keys():
    """The keys of the JAX server's summary, from its own method."""
    shadow = argparse.Namespace(
        proxy_history=[], adapt_steps=0, adapt_skips=0, regressions=0, rollbacks=0,
        snapshots=0, holds=0, frozen=False, controller=JaxMADController(),
        engine=argparse.Namespace(stats=argparse.Namespace(images=0, failed=0)))
    return list(jadapt.AdaptiveServer.summary(shadow))


@pytest.mark.parametrize("extra", [[], ["--sched"], ["--no_adapt", "--source", "video",
                                                     "--video_sessions", "2"]],
                         ids=["synthetic", "sched", "video_frozen"])
def test_serve_adaptive_main_summary(extra, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--source", "synthetic", "--synthetic_size", "64", "96", "--num_requests", "4",
            "--adapt_every", "2", "--infer_batch", "2", "--domain_shift", "1.8:0.65:8"] + extra
    summary = serve_adaptive.main(argv, device="cpu")
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"serve_adaptive": json.loads(json.dumps(summary))}
    assert list(summary) == _jax_summary_keys() + ["quality"]
    assert summary["served"] == 4 and summary["failed"] == 0
    frozen = "--no_adapt" in extra
    assert summary["adapt_steps"] == (0 if frozen else 2)
    assert len([summary["proxy_first"], summary["proxy_last"]]) == 2
    events = [json.loads(x)["event"] for x in open("runs/serve-mad/events.jsonl")]
    assert events.count("run_start") == 1 and events.count("run_end") == 1
    assert events.count("adapt_step") == (0 if frozen else 2)
    assert events.count("adapt_eval") == (2 if frozen else 0)
    heartbeat = json.load(open("runs/serve-mad/heartbeat.json"))
    assert heartbeat["mode"] == "serve_adaptive"
    assert osp.isdir("checkpoints/serve-mad_serve") != frozen


LEFT_OUT = [
    (["--aot_dir", "aot"], "item 3b"), (["--spatial_threshold", "5000"], "item 7"),
    (["--multihost"], "item 4"),
]


@pytest.mark.parametrize("flag,item", LEFT_OUT, ids=[f[0][0] for f in LEFT_OUT])
def test_serve_adaptive_refuses_what_the_port_does_not_have(flag, item, monkeypatch,
                                                            tmp_path):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=f"ROADMAP queue A, {item}"):
        serve_adaptive.main(["--source", "synthetic"] + flag, device="cpu")
    assert not os.listdir(tmp_path)  # refused before anything was built


@pytest.fixture(scope="module")
def quality_pth(tmp_path_factory):
    """A reference-style .pth of the default RAFT-Stereo, seed 1."""
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.evaluate import load_model

    path = tmp_path_factory.mktemp("quality") / "raftstereo.pth"
    model = load_model(RAFTStereoConfig(), device="cpu", seed=1)
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)
    return str(path)


COMPOSITION = {
    "cascade": ["--cascade", "--cascade_threshold", "1.0", "--quality_iters", "1"],
    "quality_ckpt": ["--cascade", "--cascade_threshold", "1.0", "--quality_iters", "1",
                     "--quality_ckpt", "QUALITY_PTH"],
    "controller": ["--sched", "--max_pending", "8", "--controller", "--controller_interval",
                   "0.01", "--controller_dwell", "0", "--controller_burn_high", "2",
                   "--controller_depth_high", "4"],
    "slo": ["--slo_p95_ms", "1e-6", "--slo_budget", "0.5"],
    "debug_port": ["--debug_port", "0"],
}


@pytest.mark.parametrize("name", list(COMPOSITION))
def test_serve_adaptive_runs_the_serving_composition(name, quality_pth, tmp_path, monkeypatch,
                                                     capsys):
    """Each flag the port used to refuse runs: the cascade escalating every
    pair to a quality tier at --quality_iters (seeded, or read from a .pth by
    --quality_ckpt), the overload controller at its cadence, dwell and bands,
    the SLO target and budget, the debug server on an ephemeral port."""
    monkeypatch.chdir(tmp_path)
    argv = ["--source", "synthetic", "--synthetic_size", "64", "96", "--num_requests", "4",
            "--adapt_every", "2", "--infer_batch", "2"]
    argv += [quality_pth if a == "QUALITY_PTH" else a for a in COMPOSITION[name]]
    summary = serve_adaptive.main(argv, device="cpu")
    assert summary["served"] == 4 and summary["failed"] == 0
    events = [json.loads(x) for x in open("runs/serve-mad/events.jsonl")]
    out = capsys.readouterr().out
    if name in ("cascade", "quality_ckpt"):
        assert summary["cascade"]["escalated"] == summary["cascade"]["replaced"] == 4
    elif name == "controller":
        holds = [e for e in events if e["event"] == "ctrl_hold"]
        assert holds and all(e["reason"] in ("calm", "band") for e in holds)
    elif name == "slo":
        assert "slo [serving]: 0.0% hit" in out
        assert "slo_budget_burn" in open("runs/serve-mad/metrics.prom").read()
    else:
        assert "[debug] introspection server on http://127.0.0.1:" in out
        assert "debug-server" not in [t.name for t in threading.enumerate()]


def test_serve_adaptive_takes_the_fast_tier(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    s = serve_adaptive.main(["--source", "synthetic", "--synthetic_size", "64", "96",
                             "--num_requests", "2", "--infer_batch", "2", "--tier", "fast",
                             "--no_adapt"], device="cpu")
    assert s["served"] == 2


def test_train_mad_refuses_multihost(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="ROADMAP queue A, item 4"):
        train_mad.main(["--multihost"], device="cpu")


@pytest.mark.parametrize("variant", ["mad", "mad2", "fusion"])
def test_train_mad_main_two_steps(variant, tmp_path, monkeypatch):
    ft.build_sceneflow(str(tmp_path), n_train=4)
    monkeypatch.chdir(tmp_path)
    base = ["--name", "t", "--variant", variant, "--batch_size", "2", "--image_size", "32",
            "64", "--validation_frequency", "100"]
    res = train_mad.main(base + ["--num_steps", "2"], device="cpu")
    assert res.total_steps == 2 and not res.preempted
    assert osp.isfile(str(res.path) + ".pt")
    rows = [json.loads(x) for x in open("runs/t/metrics.jsonl")]
    assert rows and all(np.isfinite(r["live_loss"]) for r in rows if "live_loss" in r)
    # resume continues from the final checkpoint's step
    res = train_mad.main(base + ["--num_steps", "3", "--resume", "auto"], device="cpu")
    assert res.total_steps == 3


def test_train_mad_adapt_mode(tmp_path, monkeypatch, pth):
    ft.build_sceneflow(str(tmp_path), n_train=3)
    monkeypatch.chdir(tmp_path)
    path = train_mad.main(["--name", "a", "--adapt", "mad", "--num_steps", "3",
                           "--restore_ckpt", pth], device="cpu")
    run = train_mad.last_adapt()
    assert run["path"] == str(path) and osp.isfile(str(path) + ".pt")
    assert len(run["losses"]) == 3 and all(np.isfinite(run["losses"]))
    assert len(run["distribution"]) == 5
