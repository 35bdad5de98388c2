"""Data-parallel training across processes: the port's DDP step, its loop
and its checkpoints against the JAX mesh step, on the CPU with gloo.

Two ranks are two processes (``tests/ddp_worker.py``, no JAX), meeting
through a file store in the test's directory; each is joined under a time
limit of its own and killed past it. The model is the tiny configuration
of ``tools/multihost_smoke.py`` (hidden 64x3, 2 GRU levels, 32x64, 2
iterations); its weights are drawn with numpy from a seed into the JAX
variables' shapes and carried over by ``state_dict_from_jax``. The global
batch is 2 (one sample a rank) and the ranks' valid counts differ: 25% of
rank 0's pixels, all of rank 1's.

Tolerances, each stated where it is checked:

  * loss and EPE: LOSS_RTOL = 1e-5 relative (fp32 sums in another order);
    the 1/3/5 px fractions: PX_ATOL = 1e-5 absolute;
  * Adam's first moment after a step (0.1 x the clipped, synced gradient,
    with the second step's share) per tensor: max|Δ| <= MOMENT_RTOL x
    max|mu_ref| + MOMENT_ATOL, MOMENT_RTOL = 1e-4, against JAX and for
    the port against itself (its convs at batch 1 a rank and at batch 2 may
    take other algorithms: measured up to 3.8e-5 of the scale behind the
    encoders, two iterations on). After a second step SECOND_STEP_RTOL =
    1e-3: the first update already differs where Adam's sign flipped (up
    to 2·lr an element, see below), which moves the second forward by more
    than rounding (measured: 1.5e-4 of the scale). The two encoders feed
    relus at 1/4 of 32x64, and each side decides the sign of a
    pre-activation within rounding of zero by its own sums: one flipped
    relu moves every weight gradient upstream of it by about 1/512 of its
    scale (measured on the CPU: 2.5e-3 of the scale in ``cnet``, the port
    at batch 2 against the port at batch 1 a rank; ``fnet``: see
    tests/test_torch_port_train.py). Their tensors are held to
    ENCODER_RTOL = 5e-2. A conv bias that feeds an affine-free instance
    norm has a zero gradient: rounding noise on both sides, held below
    ZERO_GRAD_RTOL = 1e-5 of its conv weight's moment scale;
  * the updated parameters, per element: Adam's update is lr·m̂/(√v̂+eps),
    so a moment known to within tol moves the update by at most
    lr·min(2, 2·tol/|mu_ref|) (two where its sign may flip); each element
    is held to the sum of that over the updates so far, plus the fp32
    rounding of the two sides' arithmetic on it, PARAM_RTOL = 1e-6 of
    |p| (four ulps), plus PARAM_ATOL;
  * the ranks among themselves, a resumed run against the run it
    continues, and a restored JAX state against JAX's: bitwise.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixture_trees as ft
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.parallel import create_train_state as jax_create_train_state
from raft_stereo_tpu.parallel import make_mesh
from raft_stereo_tpu.parallel import make_optimizer as jax_make_optimizer
from raft_stereo_tpu.parallel import make_train_step as jax_make_train_step
from raft_stereo_tpu.parallel import replicate
from raft_stereo_tpu.parallel import shard_batch as jax_shard_batch
from raft_stereo_tpu.utils.checkpoints import save_train_state_npz
from raft_stereo_tpu_torch import train
from raft_stereo_tpu_torch.config import PRESETS, RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.losses import sequence_loss
from raft_stereo_tpu_torch.models.layers import InstanceNorm, ResidualBlock, init_weights
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel import mesh
from raft_stereo_tpu_torch.parallel.train_step import create_train_state, make_train_step
from raft_stereo_tpu_torch.runtime import faultinject
from raft_stereo_tpu_torch.runtime.checkpoint import list_checkpoints, read_manifest
from raft_stereo_tpu_torch.runtime.loop import STOP_AGREE_EVERY
from raft_stereo_tpu_torch.utils.checkpoints import keyed_leaves, load_payload, restore_train_state
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ddp_worker.py")
HIDDEN, N_GRU, ITERS = (64, 64, 64), 2, 2  # as ddp_worker.py
B, H, W = 2, 32, 64
NUM_STEPS = 10  # the schedule's length (TrainConfig.num_steps), as ddp_worker.py's
CHILD_TIMEOUT_S = 120.0

LOSS_RTOL = 1e-5
PX_ATOL = 1e-5
MOMENT_RTOL, SECOND_STEP_RTOL, MOMENT_ATOL = 1e-4, 1e-3, 1e-9
ENCODER_RTOL = 5e-2
ZERO_GRAD_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-9

# the CLI runs: the small model of tests/test_torch_port_train_loop.py, at
# batch 1 a rank unless said otherwise
CLI_ARGS = ["--image_size", "32", "48", "--train_iters", "2",
            "--hidden_dims", "32", "32", "32", "--corr_levels", "2", "--corr_radius", "2",
            "--spatial_scale", "-0.2", "0.4", "--saturation_range", "0", "1.4"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.reset()
    yield
    faultinject.reset()


def _spawn(mode, workdir, label, argv=(), env_by_rank=None):
    """Start the two ranks; returns a ``join()`` that waits for each under
    CHILD_TIMEOUT_S, kills both past it, and returns their JSON."""
    procs = []
    for r in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", **(env_by_rank or {}).get(r, {}))
        log = open(os.path.join(workdir, f"{label}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, mode, str(r), "2", str(workdir), label, "--", *argv],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))

    def join():
        try:
            for p, _ in procs:
                p.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
                p.wait()
            raise
        finally:
            for _, log in procs:
                log.close()
        for r, (p, _) in enumerate(procs):
            log = os.path.join(workdir, f"{label}_rank{r}.log")
            assert p.returncode == 0, open(log).read()[-4000:]
        return [json.load(open(os.path.join(workdir, f"{label}_rank{r}.json")))
                for r in range(2)]

    return join


def _batch(seed):
    """A global batch of 2: sample 0 (rank 0's) valid on 25% of its pixels,
    sample 1 (rank 1's) on all."""
    rng = np.random.RandomState(seed)
    return {
        "img1": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "img2": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "flow": (rng.rand(B, H, W, 1) * 12.0).astype(np.float32),
        "valid": np.stack([rng.rand(H, W) < 0.25, np.ones((H, W), bool)]).astype(np.float32),
    }


def _jax_variables(model, seed=0):
    """Variables of the JAX model's shapes (``eval_shape``: no compile),
    drawn with numpy: He-scaled kernels, norm scales near 1, small biases
    and means, variances in [0.5, 1.5]."""
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, img, img, iters=1, test_mode=True),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(s.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(s.dtype)
        if name == "var":
            return (0.5 + rng.rand(*s.shape)).astype(s.dtype)
        return (0.05 * rng.randn(*s.shape)).astype(s.dtype)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' ``steps`` run (started first, so that it overlaps the JAX
    compile) and three JAX mesh steps (``make_mesh(num_data=2)``, the
    batch sharded over the data axis) on the same global batches, with
    the JAX state saved as npz after the second."""
    wd = tmp_path_factory.mktemp("ddp")
    model = JaxRAFTStereo(JaxConfig(hidden_dims=HIDDEN, n_gru_layers=N_GRU))
    variables = _jax_variables(model)
    torch.save(state_dict_from_jax(variables), wd / "init.pt")
    batches = [_batch(10 + i) for i in range(3)]
    np.savez(wd / "batches.npz", **{f"{i}_{k}": v for i, b in enumerate(batches)
                                     for k, v in b.items()})
    join = _spawn("steps", wd, "steps")

    tx, _ = jax_make_optimizer(JaxTrainConfig(num_steps=NUM_STEPS, train_iters=ITERS))
    jmesh = make_mesh(num_data=2, devices=jax.devices()[:2])
    step = jax_make_train_step(model, tx, ITERS, mesh=jmesh)
    state = replicate(jmesh, jax_create_train_state(variables, tx))
    jax_states, jax_metrics = [], []
    for i, b in enumerate(batches):
        state, metrics = step(state, jax_shard_batch(jmesh, b))
        jax_states.append(jax.device_get(state))
        jax_metrics.append({k: float(v) for k, v in metrics.items()})
        if i == 1:
            save_train_state_npz(str(wd / "jax_step2"), jax_states[-1])
    return {"wd": wd, "batches": batches, "jax_states": jax_states, "jax_metrics": jax_metrics,
            "ranks": join()}


# ------------------------------------------------------------- comparison


def _port_model():
    return RAFTStereo(RAFTStereoConfig(hidden_dims=HIDDEN, n_gru_layers=N_GRU)).train()


def _zero_gradient_biases(model):
    """{bias: its conv's weight} for each conv feeding an affine-free
    instance norm (the feature encoder's)."""
    out = {}
    for name, m in model.named_modules():
        pairs = []
        if isinstance(m, ResidualBlock):
            pairs = [("conv1", m.norm1), ("conv2", m.norm2)]
            if m.downsample is not None:
                pairs.append(("downsample.0", m.norm3))
        elif hasattr(m, "conv1") and hasattr(m, "norm1") and hasattr(m, "layer1"):
            pairs = [("conv1", m.norm1)]
        for conv, norm in pairs:
            if isinstance(norm, InstanceNorm):
                out[f"{name}.{conv}.bias"] = f"{name}.{conv}.weight"
    return out


ZERO_GRAD = _zero_gradient_biases(_port_model())


def _tensors(tree):
    """{parameter name: (parameter, exp_avg, exp_avg_sq)} of a port train
    state's tree."""
    state = tree["optimizer"]["state"]
    return {n: (tree["model"][n], state[i]["exp_avg"], state[i]["exp_avg_sq"])
            for i, (n, _) in enumerate(_port_model().named_parameters())}


def _jax_tensors(jstate):
    """The same of a JAX train state (numpy leaves), with the port's names."""
    adam = jstate.opt_state[1][0]
    params = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    mu = state_dict_from_jax({"params": adam.mu})
    nu = state_dict_from_jax({"params": adam.nu})
    return {n: (params[n], mu[n], nu[n]) for n, _ in _port_model().named_parameters()}


def _state_mismatches(got, want, lrs, rtol):
    """The parameters whose first moment or updated value is outside the
    rules of the module docstring, with their error over the allowance;
    ``lrs`` the learning rates of the updates so far."""
    bad = {}
    for n, (p, m, _) in got.items():
        p, m = p.numpy().astype(np.float64), m.numpy().astype(np.float64)
        wp, wm = (np.asarray(want[n][0], np.float64), np.asarray(want[n][1], np.float64))
        if n in ZERO_GRAD:
            tol = ZERO_GRAD_RTOL * np.abs(np.asarray(want[ZERO_GRAD[n]][1])).max() + MOMENT_ATOL
        else:
            enc = n.startswith(("fnet.", "cnet."))
            tol = (ENCODER_RTOL if enc else rtol) * np.abs(wm).max() + MOMENT_ATOL
        allow = (sum(lrs) * np.minimum(2.0, 2.0 * tol / np.maximum(np.abs(wm), 1e-30))
                 + PARAM_RTOL * np.abs(wp) + PARAM_ATOL)
        m_err = np.abs(m - wm).max() / tol
        p_err = (np.abs(p - wp) / allow).max()
        if m_err > 1 or p_err > 1:
            bad[n] = (float(m_err), float(p_err))
    return bad


def _metric_mismatches(got, want):
    bad = {}
    for k in ("live_loss", "epe"):
        if abs(got[k] - want[k]) > LOSS_RTOL * abs(want[k]):
            bad[k] = (got[k], want[k])
    for k in ("1px", "3px", "5px"):
        if abs(got[k] - want[k]) > PX_ATOL:
            bad[k] = (got[k], want[k])
    return bad


def _lrs(n):
    """The learning rates of the first ``n`` updates."""
    from raft_stereo_tpu_torch.parallel.train_step import onecycle_linear

    sched = onecycle_linear(TrainConfig().lr, NUM_STEPS + 100)
    return [sched(k) for k in range(n)]


def _ranks_bitwise(runs, k):
    return runs["ranks"][0]["ddp"][k]["digest"] == runs["ranks"][1]["ddp"][k]["digest"]


# ------------------------------------------------------------------ tests


def test_two_rank_ddp_step_equals_the_jax_mesh_step(runs):
    """Unequal valid counts (25% and 100%): the global masked mean. The
    planted per-rank mean (DDP averaging the ranks' own means) fails the
    same checks."""
    want = _jax_tensors(runs["jax_states"][0])
    got = runs["ranks"][0]["ddp"][0]["metrics"]
    assert _metric_mismatches(got, runs["jax_metrics"][0]) == {}
    assert runs["ranks"][1]["ddp"][0]["metrics"] == got  # the global metrics on both ranks
    assert _state_mismatches(_tensors(torch.load(runs["wd"] / "ddp_step1.pt")), want,
                             _lrs(1), MOMENT_RTOL) == {}
    assert _ranks_bitwise(runs, 0)

    naive = runs["ranks"][0]["naive"]["metrics"]
    assert _metric_mismatches(naive, runs["jax_metrics"][0])
    bad = _state_mismatches(_tensors(torch.load(runs["wd"] / "naive_step1.pt")), want,
                            _lrs(1), MOMENT_RTOL)
    assert len(bad) > len(want) // 2, len(bad)


def test_two_ranks_equal_one_process_on_the_concatenated_batch(runs):
    """Two steps at global batch 2 (one sample a rank) against one process
    stepping on both samples; the ranks bitwise equal after each step."""
    model = _port_model()
    model.load_state_dict(torch.load(runs["wd"] / "init.pt"), strict=True)
    state = create_train_state(model, TrainConfig(num_steps=NUM_STEPS, train_iters=ITERS))
    step = make_train_step(ITERS, nonfinite_guard=True)
    for k in (0, 1):
        state, metrics = step(state, {n: torch.from_numpy(v)
                                      for n, v in runs["batches"][k].items()})
        ranks = runs["ranks"][0]["ddp"][k]["metrics"]
        assert _metric_mismatches(ranks, {n: float(v) for n, v in metrics.items()}) == {}
        one = _tensors(state.state_dict())
        two = _tensors(torch.load(runs["wd"] / f"ddp_step{k + 1}.pt"))
        assert _state_mismatches(two, {n: (p.numpy(), m.numpy(), v.numpy())
                                       for n, (p, m, v) in one.items()},
                                 _lrs(k + 1), (MOMENT_RTOL, SECOND_STEP_RTOL)[k]) == {}
        assert _ranks_bitwise(runs, k)


def test_a_nan_on_one_rank_makes_both_ranks_skip(runs):
    """NaN in rank 1's images: both ranks skip (parameters, moments and
    schedule bitwise unchanged, the step counted); a NaN loss on rank 1
    alone, with finite gradients, is skipped on rank 0 too."""
    for r in (0, 1):
        g = runs["ranks"][r]["guard"]
        assert g == {"skipped": 1.0, "unchanged": True, "lr_and_schedule_unchanged": True,
                     "step": 3, "agreed": False}, (r, g)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_parameter_is_reached_so_ddp_looks_for_no_unused_ones(preset):
    """The DDP step passes ``find_unused_parameters=False``: DDP's reducer
    would hang or raise on a parameter the loss does not reach. No preset
    has one."""
    model = RAFTStereo(PRESETS[preset]).train()
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    img1, img2 = (torch.from_numpy((rng.rand(1, 32, 64, 3) * 255).astype(np.float32))
                  for _ in range(2))
    preds = model(img1, img2, iters=2, test_mode=False, remat=True)
    loss, _ = sequence_loss(preds, torch.full((1, 32, 64, 1), 3.0), torch.ones(1, 32, 64))
    loss.backward()
    assert [n for n, p in model.named_parameters() if p.grad is None] == []


def test_shard_batch_pieces_in_rank_order_are_the_global_batch():
    batch = _batch(0)
    pieces = [mesh.shard_batch(batch, r, 2) for r in range(2)]
    for k, v in batch.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in pieces]), v)
    assert mesh.shard_batch(batch) is not batch and mesh.world() == 1
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_batch(batch, 0, 3)


def test_init_distributed_reads_torchrun_and_a_rank_without_a_card_raises(monkeypatch):
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        assert mesh.init_distributed("cpu") == torch.device("cpu")
        assert (torch.distributed.get_backend(), mesh.rank(), mesh.world()) == ("gloo", 0, 1)
        with pytest.raises(RuntimeError, match="runs gloo, not nccl"):
            mesh.init_distributed("cpu", backend="nccl")
    finally:
        mesh.destroy()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0 has no card"):
        mesh.init_distributed()
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    ft.build_sceneflow(str(root), n_train=6)
    return root


def _events(path):
    return [json.loads(x) for x in open(path)]


def test_one_ranks_sigterm_stops_both_at_the_agreed_boundary_and_resume_is_bitwise(cli_tree):
    """``RAFT_FI_SIGTERM_STEP=1`` on rank 1 only: both ranks stop at step
    STOP_AGREE_EVERY, rank 0 commits the one emergency checkpoint; ``--resume
    auto`` on 2 ranks then ends bitwise equal to the uninterrupted run."""
    args = ["--num_steps", "6", *CLI_ARGS]
    ref = _spawn("cli", cli_tree, "ref", ["--name", "ref", "--batch_size", "1", *args])
    cut = _spawn("cli", cli_tree, "cut", ["--name", "cut", "--batch_size", "1", *args],
                 env_by_rank={1: {"RAFT_FI_SIGTERM_STEP": "1"}})
    cut_ranks, ref_ranks = cut(), ref()
    assert [(r["preempted"], r["total_steps"]) for r in cut_ranks] == \
        [(True, STOP_AGREE_EVERY)] * 2
    ckpts = list_checkpoints(str(cli_tree / "checkpoints" / "cut"))
    assert [(c.tag, c.step) for c in ckpts] == [("emergency", STOP_AGREE_EVERY)]
    commits = [e["host"] for e in _events(cli_tree / "runs" / "cut" / "events.jsonl")
               + _events(cli_tree / "runs" / "cut" / "rank1" / "events.jsonl")
               if e["event"] == "checkpoint_commit"]
    assert commits == [0]
    assert not (cli_tree / "runs" / "cut" / "rank1" / "metrics.jsonl").exists()
    assert (cli_tree / "runs" / "cut" / "metrics.jsonl").exists()

    done = _spawn("cli", cli_tree, "resume", ["--name", "cut", "--batch_size", "1", "--resume", "auto", *args])()
    assert [(r["preempted"], r["total_steps"], r["stream_pos"]) for r in done] == \
        [(False, 6, 6)] * 2
    assert [r["total_steps"] for r in ref_ranks] == [6, 6]
    a = load_payload(str(cli_tree / "checkpoints" / "ref" / "ref"))["state"]
    b = load_payload(str(cli_tree / "checkpoints" / "cut" / "cut"))["state"]
    ka, kb = keyed_leaves(a), keyed_leaves(b)
    assert set(ka) == set(kb) and all(
        torch.equal(ka[k], kb[k]) if isinstance(ka[k], torch.Tensor) else ka[k] == kb[k]
        for k in ka)
    assert not any(k.startswith("module.") for k in a["model"])


def test_checkpoints_move_between_one_and_two_processes(cli_tree, monkeypatch):
    """A 2-rank checkpoint resumes on 1 process, and a 1-process one on 2
    ranks: same keys, restored exactly, the run continued to its end."""
    monkeypatch.chdir(cli_tree)
    two = _spawn("cli", cli_tree, "two", ["--name", "two", "--num_steps", "2",
                                          "--batch_size", "1", *CLI_ARGS])()
    assert [r["total_steps"] for r in two] == [2, 2]
    one = train.main(["--name", "one", "--num_steps", "2", "--batch_size", "2", *CLI_ARGS],
                     device="cpu")
    saved_two = load_payload(str(cli_tree / "checkpoints" / "two" / "two"))["state"]
    saved_one = load_payload(str(one.path))["state"]
    assert set(keyed_leaves(saved_two)) == set(keyed_leaves(saved_one))

    model = RAFTStereo(RAFTStereoConfig(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2))
    state = create_train_state(model.train(), TrainConfig(num_steps=4))
    restored = keyed_leaves(restore_train_state(str(cli_tree / "checkpoints" / "two" / "two"),
                                                state).state_dict())
    assert all(torch.equal(v, restored[k]) if isinstance(v, torch.Tensor) else v == restored[k]
               for k, v in keyed_leaves(saved_two).items())

    on_one = train.main(["--name", "two", "--resume", "auto", "--num_steps", "4",
                         "--batch_size", "1", *CLI_ARGS], device="cpu")
    assert on_one.total_steps == 4 and not on_one.preempted
    events = _events(cli_tree / "runs" / "two" / "events.jsonl")
    assert [e["step"] for e in events if e["event"] == "resume"] == [2]
    assert [e["run"]["num_shards"] for e in events if e["event"] == "geometry_change"] == [1]

    on_two = _spawn("cli", cli_tree, "one_on_two",
                    ["--name", "one", "--resume", "auto", "--num_steps", "4",
                     "--batch_size", "1", *CLI_ARGS])()
    assert [(r["total_steps"], r["preempted"]) for r in on_two] == [(4, False)] * 2
    assert read_manifest(str(cli_tree / "checkpoints" / "one" / "one"))["step"] == 4


def test_jax_npz_train_state_restores_exactly_and_steps_like_jax(runs):
    """JAX's state after two steps (``save_train_state_npz``) restores into
    the port bitwise (parameters, moments, step, schedule); one more port
    step matches JAX's third. An orbax directory is refused."""
    jstate = runs["jax_states"][1]
    want = _jax_tensors(jstate)
    model = _port_model()
    state = create_train_state(model, TrainConfig(num_steps=NUM_STEPS, train_iters=ITERS))
    state = restore_train_state(str(runs["wd"] / "jax_step2"), state)  # path.npz found
    for n, (p, m, v) in _tensors(state.state_dict()).items():
        for got, w in ((p, want[n][0]), (m, want[n][1]), (v, want[n][2])):
            assert np.array_equal(got.numpy(), np.asarray(w)), n
    bn = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for n, buf in model.named_buffers():
        assert torch.equal(buf, bn[n]), n
    count = int(jstate.opt_state[1][0].count)
    assert state.step == int(jstate.step) == count == 2
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {2.0}
    assert state.scheduler.last_epoch == 2 and state.lr == _lrs(3)[2]

    step = make_train_step(ITERS, nonfinite_guard=True)
    state, metrics = step(state, {n: torch.from_numpy(v) for n, v in runs["batches"][2].items()})
    assert _metric_mismatches({k: float(v) for k, v in metrics.items()},
                              runs["jax_metrics"][2]) == {}
    assert _state_mismatches(_tensors(state.state_dict()), _jax_tensors(runs["jax_states"][2]),
                             _lrs(3), MOMENT_RTOL) == {}

    (runs["wd"] / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="orbax imports JAX"):
        restore_train_state(str(runs["wd"] / "orbax_dir"), state)
