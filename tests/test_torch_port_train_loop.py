"""Training, the runtime layer: the port's checkpoint format (commit,
manifest, verification, rotation, torn writes, single-read resume), the
guard, the pipelined loop and the train CLI end to end on the CPU.

It mirrors tests/test_runtime.py:90-216 and tests/test_pipeline_loop.py:
134-412 of the JAX package on the port's format (one ``torch.save``
payload + a JSON manifest). The states are trees of tensors, or the
train state; "bitwise" means ``torch.equal`` on every leaf.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

import fixture_trees as ft
from raft_stereo_tpu_torch import train
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.parallel.train_step import create_train_state
from raft_stereo_tpu_torch.runtime import faultinject
from raft_stereo_tpu_torch.runtime.checkpoint import (
    clone_checkpoint,
    commit_checkpoint,
    find_latest_checkpoint,
    list_checkpoints,
    read_manifest,
    restore_latest_verified,
    rotate_checkpoints,
    verify_checkpoint,
)
from raft_stereo_tpu_torch.runtime.guard import NonFiniteGuard, NonFiniteStepError
from raft_stereo_tpu_torch.runtime.loop import (
    AsyncCheckpointer,
    DeviceStager,
    cpu_stage_fn,
    run_training_loop,
)
from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown
from raft_stereo_tpu_torch.utils.checkpoints import keyed_leaves, load_payload, restore_train_state
from raft_stereo_tpu_torch.utils.metrics import MetricLogger, NonFiniteMetricError


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.reset()
    yield
    faultinject.reset()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state(step: int, fill: float = 0.0):
    return {"step": step,
            "params": {"w": torch.full((2, 3), fill), "b": torch.arange(4.0) + fill}}


def _same_tree(a, b) -> bool:
    ka, kb = keyed_leaves(a), keyed_leaves(b)
    if set(ka) != set(kb):
        return False
    for k in ka:
        x, y = ka[k], kb[k]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def _flip_payload_byte(base: str, fill: float = 2.0) -> None:
    """Bit-rot in a leaf: flip one byte inside the stored data of the
    ``w`` leaf (six float32 ``fill`` values)."""
    target = base + ".pt"
    data = bytearray(open(target, "rb").read())
    at = data.find(np.full(6, fill, np.float32).tobytes())
    assert at >= 0
    data[at + 5] ^= 0xFF
    open(target, "wb").write(bytes(data))


# ------------------------------------------------------------ checkpoints


def test_commit_verify_restore_roundtrip(tmp_path):
    state = _state(5, fill=1.5)
    info = commit_checkpoint(str(tmp_path / "5_run"), state, step=5, extra={"stream_pos": 7})
    assert info.step == 5 and info.tag == "periodic"
    assert verify_checkpoint(info.path)
    manifest = read_manifest(info.path)
    assert manifest["leaf_count"] == 3 and manifest["stream_pos"] == 7
    assert all("crc32" in e and "shape" in e for e in manifest["leaves"].values())
    assert load_payload(info.path)["stream_pos"] == 7
    assert _same_tree(restore_train_state(info.path, _state(0)), state)


def test_train_state_roundtrip_is_bitwise(tmp_path):
    """Parameters, Adam moments, step and lr come back bitwise."""
    model = load_model(RAFTStereoConfig(hidden_dims=(32, 32, 32), corr_levels=2,
                                        corr_radius=2), device="cpu")
    cfg = TrainConfig(lr=1e-3, num_steps=10)
    state = create_train_state(model, cfg)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state.step = 1
    info = commit_checkpoint(str(tmp_path / "1_run"), state, step=1)
    fresh = create_train_state(load_model(model.config, device="cpu", seed=3), cfg)
    restored = restore_train_state(info.path, fresh)
    assert restored is fresh and restored.step == 1 and restored.lr == state.lr
    assert _same_tree(restored.state_dict(), state.state_dict())


def test_atomic_commit_survives_injected_crash(tmp_path):
    commit_checkpoint(str(tmp_path / "5_run"), _state(5, 1.0), step=5)
    faultinject.arm(crash="ckpt_commit")
    with pytest.raises(faultinject.InjectedCrash):
        commit_checkpoint(str(tmp_path / "10_run"), _state(10, 2.0), step=10)
    faultinject.reset()
    assert read_manifest(str(tmp_path / "10_run")) is None
    assert not (tmp_path / "10_run.pt").exists()
    latest = find_latest_checkpoint(str(tmp_path))
    assert latest is not None and latest.step == 5
    assert _same_tree(restore_train_state(latest.path, _state(0)), _state(5, 1.0))


def test_crash_between_payload_and_manifest_is_torn(tmp_path):
    commit_checkpoint(str(tmp_path / "5_run"), _state(5, 1.0), step=5)
    faultinject.arm(crash="manifest_commit")
    with pytest.raises(faultinject.InjectedCrash):
        commit_checkpoint(str(tmp_path / "10_run"), _state(10, 2.0), step=10)
    faultinject.reset()
    assert (tmp_path / "10_run.pt").exists()  # the payload landed, its record did not
    assert find_latest_checkpoint(str(tmp_path)).step == 5


def test_manifest_rejects_bitflipped_leaf(tmp_path):
    commit_checkpoint(str(tmp_path / "5_run"), _state(5, 1.0), step=5)
    newer = commit_checkpoint(str(tmp_path / "10_run"), _state(10, 2.0), step=10)
    assert verify_checkpoint(newer.path)
    _flip_payload_byte(newer.path)
    assert not verify_checkpoint(newer.path)
    latest = find_latest_checkpoint(str(tmp_path))
    assert latest.step == 5


def test_find_latest_ignores_manifestless_leftovers(tmp_path):
    commit_checkpoint(str(tmp_path / "7_run"), _state(7), step=7)
    (tmp_path / "99_run.pt.tmp").write_bytes(b"torn")
    (tmp_path / "98_run.pt").write_bytes(b"not a checkpoint")
    assert find_latest_checkpoint(str(tmp_path)).step == 7


def test_rotation_keeps_last_k_plus_final_and_newest_emergency(tmp_path):
    commit_checkpoint(str(tmp_path / "0_run"), _state(0), step=0, tag="emergency")
    for s in (1, 2, 3, 4, 5):
        commit_checkpoint(str(tmp_path / f"{s}_run"), _state(s), step=s)
    commit_checkpoint(str(tmp_path / "6_run"), _state(6), step=6, tag="emergency")
    commit_checkpoint(str(tmp_path / "run"), _state(5), step=5, tag="final")
    removed = rotate_checkpoints(str(tmp_path), keep=2)
    assert sorted(r.step for r in removed) == [0, 1, 2, 3]
    remaining = list_checkpoints(str(tmp_path))
    assert sorted((c.step, c.tag) for c in remaining) == [
        (4, "periodic"), (5, "final"), (5, "periodic"), (6, "emergency")]
    assert all(verify_checkpoint(c.path) for c in remaining)
    assert not (tmp_path / "1_run.pt").exists()


def test_rotation_sweeps_crash_debris_but_not_manifestless_payloads(tmp_path):
    kept = commit_checkpoint(str(tmp_path / "4_run"), _state(4), step=4)
    (tmp_path / "run_extra.pt").write_bytes(b"a payload without a manifest")
    (tmp_path / "7_run.pt.tmp").write_bytes(b"debris")
    (tmp_path / "7_run.old").mkdir()
    (tmp_path / "5_run.manifest.json.tmp").write_text("{}")
    rotate_checkpoints(str(tmp_path), keep=3)
    leftover = sorted(p.name for p in tmp_path.iterdir())
    assert "run_extra.pt" in leftover
    assert not any(n.endswith((".tmp", ".old")) for n in leftover)
    assert verify_checkpoint(kept.path)


def test_clone_checkpoint_dedupes_final(tmp_path):
    src = commit_checkpoint(str(tmp_path / "9_run"), _state(9, 3.0), step=9)
    clone_checkpoint(src.path, str(tmp_path / "run"), tag="final")
    assert verify_checkpoint(str(tmp_path / "run"))
    assert read_manifest(str(tmp_path / "run"))["tag"] == "final"
    assert _same_tree(restore_train_state(str(tmp_path / "run"), _state(0)), _state(9, 3.0))


def test_restore_missing_raises_clear_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        restore_train_state(str(tmp_path / "does_not_exist"), _state(0))


def test_restore_takes_a_reference_pth(tmp_path):
    """A released reference checkpoint warm-starts the model (``module.``
    stripped, strict); the optimizer and the step stay fresh."""
    cfg = RAFTStereoConfig(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
    src = load_model(cfg, device="cpu", seed=5)
    torch.save({"module." + k: v for k, v in src.state_dict().items()}, tmp_path / "ref.pth")
    state = create_train_state(load_model(cfg, device="cpu", seed=6), TrainConfig())
    restore_train_state(str(tmp_path / "ref.pth"), state)
    assert state.step == 0
    assert _same_tree(state.model.state_dict(), src.state_dict())


def test_restore_latest_verified_is_single_read(tmp_path, monkeypatch):
    import raft_stereo_tpu_torch.runtime.checkpoint as ck

    commit_checkpoint(str(tmp_path / "5_run"), _state(5, 1.0), step=5)
    commit_checkpoint(str(tmp_path / "10_run"), _state(10, 2.0), step=10)
    reads = []
    real = ck.load_payload
    monkeypatch.setattr(ck, "load_payload", lambda p: reads.append(p) or real(p))

    def no_second_read(path):
        raise AssertionError("target-free verification read must not happen")

    monkeypatch.setattr(ck, "load_keyed_leaves", no_second_read)
    info, state, manifest = restore_latest_verified(str(tmp_path), _state(0))
    assert info.step == 10 and manifest["step"] == 10 and len(reads) == 1
    assert _same_tree(state, _state(10, 2.0))


def test_restore_latest_verified_raises_on_target_mismatch(tmp_path):
    commit_checkpoint(str(tmp_path / "5_run"), _state(5, 1.0), step=5)
    bad_target = dict(_state(0), extra=torch.zeros(3))
    with pytest.raises(KeyError):
        restore_latest_verified(str(tmp_path), bad_target)


def test_restore_latest_verified_skips_corrupt_newest(tmp_path):
    commit_checkpoint(str(tmp_path / "5_run"), _state(5, 1.0), step=5)
    newer = commit_checkpoint(str(tmp_path / "10_run"), _state(10, 2.0), step=10)
    _flip_payload_byte(newer.path)
    hit = restore_latest_verified(str(tmp_path), _state(0))
    assert hit is not None and hit[0].step == 5
    assert _same_tree(hit[1], _state(5, 1.0))


# ------------------------------------------------------------ guard, signals


def test_nonfinite_guard_aborts_on_streak():
    g = NonFiniteGuard(max_consecutive=3, check_every=2)
    g.observe(1, 0.0)
    g.observe(2, 1.0)
    assert g.consecutive == 1
    g.observe(3, 1.0)
    with pytest.raises(NonFiniteStepError, match="3 consecutive"):
        g.observe(4, 1.0)
    assert g.total_skipped == 3
    g2 = NonFiniteGuard(max_consecutive=2, check_every=1)
    for step, flag in ((1, 1.0), (2, 0.0), (3, 1.0), (4, 0.0)):
        g2.observe(step, flag)
    assert g2.consecutive == 0 and g2.total_skipped == 2


def test_graceful_shutdown_latches_sigterm():
    import signal

    with GracefulShutdown() as stopper:
        assert not stopper.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert stopper.should_stop and stopper.last_signal == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is not stopper._handle


def test_metric_logger_breakdown_and_fail_fast(tmp_path):
    mlog = MetricLogger(run_dir=str(tmp_path / "run"))
    mlog.push(1, {"loss": torch.tensor(1.0)},
              timing={"data_wait": 0.5, "h2d_stage": 0.25, "device_step": 1.0})
    mlog.push(2, {"loss": 2.0}, timing={"data_wait": 0.0, "h2d_stage": 0.25, "device_step": 1.0})
    mlog.flush()
    mlog.push(3, {"loss": float("nan")})
    with pytest.raises(NonFiniteMetricError):
        mlog.close()
    rows = [json.loads(ln) for ln in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["marker"] == "logger_start"
    assert rows[1]["time/data_wait"] == pytest.approx(0.25)
    assert rows[1]["loss"] == pytest.approx(1.5)
    assert rows[2]["loss"] == "nan"  # the evidence row, strict JSON


# ------------------------------------------------------------------ loop


def _toy_step(state, batch):
    """A deterministic stand-in step: w accumulates the batch mean, so any
    reordering, duplication or drop of batches changes the result."""
    img = batch["img1"].double()
    bad = not bool(torch.isfinite(img).all())
    w = state["params"]["w"]
    new = {"step": state["step"] + 1,
           "params": {"w": w if bad else (w + float(img.mean()) * 0.125).float()}}
    return new, {"live_loss": 0.0 if bad else float(img.mean()), "skipped": 1.0 if bad else 0.0}


def _toy_state(step=0):
    return {"step": step, "params": {"w": torch.zeros(())}}


class _SyntheticDS:
    """In-memory dataset: the pixel value encodes the sample index."""

    def __len__(self):
        return 16

    def __getitem__(self, index, rng=None):
        img = np.full((4, 4, 3), float(index), np.float32)
        return img, img, np.zeros((4, 4, 1), np.float32), np.ones((4, 4), np.float32)


def _loader():
    from raft_stereo_tpu_torch.data.datasets import PrefetchLoader

    return PrefetchLoader(_SyntheticDS(), batch_size=4, num_workers=2, seed=0)


def _run(tmp_path, *, num_steps, prefetch_depth, async_ckpt, state=None,
         validation_frequency=100, resumed=False, resume_manifest=None, stream_pos=0,
         guard=None, name="toy"):
    ckpt_dir = tmp_path / "ck"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    return run_training_loop(
        state=state if state is not None else _toy_state(), step_fn=_toy_step,
        loader=_loader(), stage_fn=cpu_stage_fn, ckpt_dir=ckpt_dir, name=name,
        num_steps=num_steps, validation_frequency=validation_frequency, keep_ckpts=2,
        guard=guard, resumed=resumed, resume_manifest=resume_manifest, stream_pos=stream_pos,
        prefetch_depth=prefetch_depth, async_ckpt=async_ckpt, run_dir=str(tmp_path / "run"))


def test_stager_preserves_order_and_surfaces_errors():
    batches = [{"img1": np.full((2, 2), float(i))} for i in range(10)]
    stager = DeviceStager(iter(batches), cpu_stage_fn, depth=2)
    seen = []
    while (item := stager.get()) is not None:
        seen.append(float(item[0]["img1"][0, 0]))
        assert item[1] >= 0.0 and item[2] >= 0.0
    stager.close()
    assert seen == [float(i) for i in range(10)]

    def bad_iter():
        yield {"img1": np.zeros((2, 2))}
        raise OSError("loader died")

    stager = DeviceStager(bad_iter(), cpu_stage_fn, depth=2)
    assert stager.get() is not None
    with pytest.raises(OSError, match="loader died"):
        stager.get()
    stager.close()
    many = ({"img1": np.zeros((2, 2))} for _ in range(10_000))
    stager = DeviceStager(many, cpu_stage_fn, depth=1)
    assert stager.get() is not None
    stager.close()
    assert not stager._thread.is_alive()


def test_async_committer_one_in_flight_and_failure_surfaces(tmp_path, monkeypatch):
    import raft_stereo_tpu_torch.runtime.loop as loop_mod

    active = {"n": 0, "max": 0, "done": []}
    real_commit = loop_mod.commit_checkpoint

    def slow_commit(path, state, **kw):
        active["n"] += 1
        active["max"] = max(active["max"], active["n"])
        time.sleep(0.05)
        info = real_commit(path, state, **kw)
        active["n"] -= 1
        active["done"].append(kw["step"])
        return info

    monkeypatch.setattr(loop_mod, "commit_checkpoint", slow_commit)
    ck = AsyncCheckpointer()
    live = _state(1)
    ck.commit_async(str(tmp_path / "1_t"), live, step=1)
    live["params"]["w"].add_(5.0)  # the snapshot was taken before this update
    ck.commit_async(str(tmp_path / "2_t"), _state(2), step=2)
    assert 1 in active["done"]
    ck.close()
    assert active["max"] == 1 and active["done"] == [1, 2]
    assert _same_tree(restore_train_state(str(tmp_path / "1_t"), _state(0)), _state(1))

    monkeypatch.setattr(loop_mod, "commit_checkpoint",
                        lambda path, state, **kw: (_ for _ in ()).throw(OSError("disk full")))
    ck = AsyncCheckpointer()
    ck.commit_async(str(tmp_path / "3_t"), _state(3), step=3)
    with pytest.raises(OSError, match="disk full"):
        ck.join()
    ck.close()


def test_pipelined_loop_matches_synchronous_loop(tmp_path):
    ra = _run(tmp_path / "a", num_steps=6, prefetch_depth=0, async_ckpt=False)
    rb = _run(tmp_path / "b", num_steps=6, prefetch_depth=3, async_ckpt=True)
    assert ra.total_steps == rb.total_steps == 6
    assert torch.equal(ra.state["params"]["w"], rb.state["params"]["w"])
    for r in (ra, rb):
        m = read_manifest(str(r.final_path))
        assert m["step"] == 6 and m["tag"] == "final" and verify_checkpoint(str(r.final_path))
    assert ra.timings.steps == rb.timings.steps == 6 and len(rb.timings.step_seconds) == 6
    hb = json.loads((tmp_path / "b" / "run" / "heartbeat.json").read_text())
    assert hb["step"] == 6 and hb["num_steps"] == 6 and not hb["preempted"]


def test_kill_mid_epoch_with_prefetch_then_resume_bit_identical(tmp_path):
    ref = _run(tmp_path / "ref", num_steps=6, prefetch_depth=0, async_ckpt=False)
    faultinject.arm(sigterm_step=3)
    killed = _run(tmp_path / "fi", num_steps=6, prefetch_depth=2, async_ckpt=True)
    faultinject.reset()
    assert killed.preempted and killed.total_steps == 3
    info = find_latest_checkpoint(str(tmp_path / "fi" / "ck"))
    assert info.step == 3 and info.tag == "emergency"
    manifest = read_manifest(info.path)
    assert manifest["stream_pos"] == 3  # prefetched batches do not count
    restored = restore_train_state(info.path, _toy_state())
    resumed = _run(tmp_path / "fi", num_steps=6, prefetch_depth=2, async_ckpt=True,
                   state=restored, resumed=True, resume_manifest=manifest,
                   stream_pos=int(manifest["stream_pos"]))
    assert resumed.total_steps == 6 and not resumed.preempted
    assert torch.equal(resumed.state["params"]["w"], ref.state["params"]["w"])
    a = restore_train_state(str(ref.final_path), _toy_state())
    b = restore_train_state(str(resumed.final_path), _toy_state())
    assert _same_tree(a, b)


@pytest.mark.parametrize("crash", ["manifest_commit", "ckpt_commit"])
def test_async_commit_crash_leaves_no_checkpoint(tmp_path, crash):
    faultinject.arm(crash=crash)
    with pytest.raises(faultinject.InjectedCrash):
        _run(tmp_path, num_steps=6, prefetch_depth=2, async_ckpt=True, validation_frequency=2)
    faultinject.reset()
    ckpt_dir = tmp_path / "ck"
    assert read_manifest(str(ckpt_dir / "2_toy")) is None
    assert find_latest_checkpoint(str(ckpt_dir)) is None
    assert not glob.glob(str(ckpt_dir / "*.manifest.json"))


def test_periodic_async_commits_are_valid_and_rotated(tmp_path):
    r = _run(tmp_path, num_steps=6, prefetch_depth=2, async_ckpt=True, validation_frequency=2)
    ckpt_dir = tmp_path / "ck"
    kept = sorted(c.step for c in list_checkpoints(str(ckpt_dir)) if c.tag == "periodic")
    assert kept == [4, 6]
    assert all(verify_checkpoint(str(ckpt_dir / f"{s}_toy")) for s in kept)
    m = read_manifest(str(r.final_path))
    assert m["step"] == 6 and m["tag"] == "final"
    assert r.timings.ckpt_commits == 3


def test_nan_injection_rides_the_stager_and_guard_observes(tmp_path):
    faultinject.arm(nan_step=2)
    guard = NonFiniteGuard(max_consecutive=3, check_every=1)
    r = _run(tmp_path, num_steps=4, prefetch_depth=2, async_ckpt=False, guard=guard)
    assert r.total_steps == 4 and guard.total_skipped == 1
    faultinject.reset()
    clean = _run(tmp_path / "clean", num_steps=4, prefetch_depth=2, async_ckpt=False)
    assert float(r.state["params"]["w"]) != float(clean.state["params"]["w"])


# ------------------------------------------------------------------- CLI


TRAIN_ARGS = ["--batch_size", "2", "--image_size", "32", "48", "--train_iters", "2",
              "--hidden_dims", "32", "32", "32", "--corr_levels", "2", "--corr_radius", "2",
              "--spatial_scale", "-0.2", "0.4", "--saturation_range", "0", "1.4"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    ft.build_sceneflow(str(tmp_path), n_train=6)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _rows(run_dir):
    return [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_end_to_end_on_the_cpu(tree, monkeypatch):
    monkeypatch.setenv("RAFT_FI_NAN_STEP", "2")
    result = train.main(["--name", "cli", "--num_steps", "3", *TRAIN_ARGS], device="cpu")
    assert result.total_steps == 3 and not result.preempted
    final = tree / "checkpoints" / "cli" / "cli"
    assert result.path.resolve() == final
    m = read_manifest(str(final))
    assert m["step"] == 3 and m["tag"] == "final" and m["stream_pos"] == 3
    assert m["stream_geometry"] == {"batch_size": 2, "num_shards": 1, "dataset_len": 6}
    assert verify_checkpoint(str(final))
    rows = [r for r in _rows(tree / "runs" / "cli") if "step" in r]
    assert rows[-1]["skipped"] == pytest.approx(1 / 3)  # one step of three skipped
    assert "time/device_step" in rows[-1] and np.isfinite(rows[-1]["live_loss"])
    assert json.loads((tree / "runs" / "cli" / "heartbeat.json").read_text())["step"] == 3


def test_train_cli_sigterm_then_resume_equals_uninterrupted_run(tree, monkeypatch):
    """Also: the pipelined loop (prefetch, async periodic commits every 2
    steps) ends bitwise equal to the synchronous one."""
    args = ["--num_steps", "4", "--validation_frequency", "2", *TRAIN_ARGS]
    ref = train.main(["--name", "ref", *args], device="cpu")
    sync = train.main(["--name", "sync", "--prefetch_depth", "0", "--no-async_ckpt", *args],
                      device="cpu")
    assert _same_tree(load_payload(str(ref.path))["state"],
                      load_payload(str(sync.path))["state"])
    assert read_manifest(str(ref.path.parent / "4_ref"))["tag"] == "periodic"
    monkeypatch.setenv("RAFT_FI_SIGTERM_STEP", "2")
    cut = train.main(["--name", "cut", *args], device="cpu")
    assert cut.preempted and cut.total_steps == 2
    emergency = read_manifest(str(cut.path))
    assert emergency["tag"] == "emergency" and emergency["step"] == 2
    monkeypatch.delenv("RAFT_FI_SIGTERM_STEP")
    faultinject.reset()
    done = train.main(["--name", "cut", "--resume", "auto", *args], device="cpu")
    assert done.total_steps == 4 and not done.preempted
    a = load_payload(str(ref.path))
    b = load_payload(str(done.path))
    assert a["stream_pos"] == b["stream_pos"] == 4
    assert _same_tree(a["state"], b["state"])  # parameters, moments, step and lr bitwise


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--name", "x", "--num_steps", "1", *TRAIN_ARGS])
    assert not (tree / "checkpoints").exists()
