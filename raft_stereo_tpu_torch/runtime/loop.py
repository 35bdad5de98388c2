"""The pipelined training loop (the port's own copy of
``raft_stereo_tpu/runtime/loop.py:87-871``, in one process).

  * ``DeviceStager``: a background thread pulls host batches from the
    loader stream, applies NaN fault injection and stages each batch for
    the device while the current step computes, behind a bounded FIFO, so
    the batch order (and so the resume position) is the synchronous
    loop's. On the card (:func:`cuda_stage_fn`) a batch is copied from
    pinned host memory with ``non_blocking`` copies on a side stream, and
    the step waits on the copy's event.
  * ``AsyncCheckpointer``: a periodic checkpoint is snapshotted to the host
    (a copy taken before the next step changes the parameters) and
    committed on one committer thread, at most one commit in flight;
    emergency and final commits stay synchronous and join it first.
  * ``run_training_loop``: resume geometry check, mid-epoch fast-forward,
    the guard, SIGTERM → emergency checkpoint, periodic commit + rotation
    + validation, the final checkpoint (deduped from a periodic commit of
    the same step), the heartbeat, and the per-step wall-time breakdown
    (``data_wait``, ``h2d_stage``, ``device_step``, ``ckpt_stall``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.runtime import faultinject
from raft_stereo_tpu_torch.runtime.checkpoint import (
    CheckpointInfo,
    clone_checkpoint,
    commit_checkpoint,
    read_manifest,
    restore_latest_verified,
    rotate_checkpoints,
    verify_checkpoint,
)
from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown
from raft_stereo_tpu_torch.utils.checkpoints import restore_train_state, state_tree, to_host

logger = logging.getLogger(__name__)

_END = object()  # stager sentinel: the batch stream is exhausted

HEARTBEAT_NAME = "heartbeat.json"


def _state_step(state) -> int:
    """The optimizer step recorded on a train state (attribute or key)."""
    step = getattr(state, "step", None)
    if step is None and isinstance(state, dict):
        step = state.get("step", 0)
    return int(0 if step is None else step)


def _poison_batch(step: int, batch: Dict[str, Any]) -> Dict[str, Any]:
    """NaN-poison the left image when ``step`` is the armed injection step
    (the image, not the GT, so the NaN reaches the loss and gradients)."""
    if faultinject.poison_nan(step):
        batch = dict(batch, img1=np.full_like(batch["img1"], np.nan))
    return batch


# --------------------------------------------------------------- staging


class StagedBatch:
    """A batch copied to the card on a side stream: ``get()`` makes the
    current stream wait on the copy's event and returns the tensors."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event, pinned, device):
        self._tensors = tensors
        self._event = event
        self._pinned = pinned  # alive until the copies are done
        self._device = device

    def get(self) -> Dict[str, torch.Tensor]:
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(self._event)
        for t in self._tensors.values():
            t.record_stream(stream)
        self._pinned = None
        return self._tensors


def cpu_stage_fn(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Host batches as CPU tensors (shares the numpy memory)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def cuda_stage_fn(device: torch.device) -> Callable[[Dict[str, np.ndarray]], StagedBatch]:
    """Stage host batches on ``device``: pinned host copies, ``non_blocking``
    copies on a side stream, an event the step waits on (``StagedBatch``)."""
    stream = torch.cuda.Stream(device)

    def stage(batch: Dict[str, np.ndarray]) -> StagedBatch:
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(stream):
            out = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return StagedBatch(out, event, pinned, device)

    return stage


def unstage(staged) -> Dict[str, torch.Tensor]:
    """The tensors of a staged batch (waiting on its copy on the card)."""
    return staged.get() if isinstance(staged, StagedBatch) else staged


class DeviceStager:
    """Background thread staging host batches ahead of the loop.

    ``get()`` returns ``(staged, stage_seconds, wait_seconds)`` in exactly
    the order the iterator produced them, or None when the stream is
    exhausted; a worker exception re-raises in the consumer."""

    def __init__(self, batch_iter: Iterator[Dict[str, Any]],
                 stage_fn: Callable[[Dict[str, Any]], Any], *, depth: int = 2,
                 start_step: int = 0, inject_nan: bool = True):
        if depth < 1:
            raise ValueError("DeviceStager depth must be >= 1")
        self._iter = batch_iter
        self._stage_fn = stage_fn
        self._inject_nan = inject_nan
        self._start_step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="device-stager", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        step = self._start_step
        try:
            for batch in self._iter:
                step += 1  # the train step this batch will feed
                if self._inject_nan:
                    batch = _poison_batch(step, batch)
                t0 = time.perf_counter()
                staged = self._stage_fn(batch)
                if not self._put((staged, time.perf_counter() - t0)):
                    return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
            self._put(e)

    def get(self):
        """Next staged batch (FIFO): ``(batch, stage_s, wait_s)`` or None."""
        t0 = time.perf_counter()
        item = self._q.get()
        wait_s = time.perf_counter() - t0
        if item is _END:
            return None
        if isinstance(item, BaseException):
            raise item
        staged, stage_s = item
        return staged, stage_s, wait_s

    def close(self) -> None:
        """Stop the worker, drop prefetched batches and close the stream
        (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive():
            close_iter = getattr(self._iter, "close", None)
            if close_iter is not None:
                close_iter()


class _SyncStager:
    """Synchronous drop-in for ``DeviceStager`` (``--prefetch_depth 0``):
    staging inline on the consumer's thread."""

    def __init__(self, batch_iter, stage_fn, *, start_step=0, inject_nan=True):
        self._iter = batch_iter
        self._stage_fn = stage_fn
        self._inject_nan = inject_nan
        self._step = start_step

    def get(self):
        t0 = time.perf_counter()
        try:
            batch = next(self._iter)
        except StopIteration:
            return None
        self._step += 1
        if self._inject_nan:
            batch = _poison_batch(self._step, batch)
        wait_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        staged = self._stage_fn(batch)
        return staged, time.perf_counter() - t1, wait_s

    def close(self) -> None:
        close_iter = getattr(self._iter, "close", None)
        if close_iter is not None:
            close_iter()


# ------------------------------------------------------------- committer


class AsyncCheckpointer:
    """One committer thread running the atomic commit protocol.

    ``commit_async`` snapshots the state to host memory (a copy) on the
    caller's thread and hands it to the committer, which runs
    ``commit_checkpoint`` and then rotation. At most one commit is in
    flight: a new request joins the previous one first. A committer failure
    re-raises on the training thread at the next ``poll()`` or ``join()``."""

    def __init__(self):
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-committer")
        self._inflight: Optional[Future] = None

    def commit_async(self, path: str, state, *, step: int, tag: str = "periodic",
                     extra: Optional[dict] = None, rotate_dir: Optional[str] = None,
                     keep: int = 3) -> CheckpointInfo:
        self.join()  # at most one commit in flight
        host_state = to_host(state_tree(state), copy=True)

        def _commit():
            info = commit_checkpoint(path, host_state, step=step, tag=tag, extra=extra)
            if rotate_dir is not None:
                rotate_checkpoints(rotate_dir, keep=keep)
            return info

        self._inflight = self._executor.submit(_commit)
        return CheckpointInfo(path=os.path.abspath(path), step=step, tag=tag)

    def poll(self) -> None:
        """Surface a finished-and-failed commit without blocking."""
        if self._inflight is not None and self._inflight.done():
            fut, self._inflight = self._inflight, None
            fut.result()

    def join(self) -> None:
        """Block until the in-flight commit (if any) has published."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self) -> None:
        try:
            self.join()
        finally:
            self._executor.shutdown(wait=True)


# ----------------------------------------------------------------- loop


@dataclass
class StepTimeBreakdown:
    """Wall-time accounting for the loop (seconds, summed over steps; each
    step's device step and data wait also kept one by one)."""

    steps: int = 0
    data_wait: float = 0.0
    h2d_stage: float = 0.0
    device_step: float = 0.0
    ckpt_stall: float = 0.0
    ckpt_commits: int = 0
    step_seconds: List[float] = field(default_factory=list)
    wait_seconds: List[float] = field(default_factory=list)

    def add(self, wait_s: float, stage_s: float, step_s: float) -> None:
        self.steps += 1
        self.data_wait += wait_s
        self.h2d_stage += stage_s
        self.device_step += step_s
        self.step_seconds.append(step_s)
        self.wait_seconds.append(wait_s)

    def stall(self, seconds: float) -> None:
        self.ckpt_stall += seconds
        self.ckpt_commits += 1

    def means(self) -> Dict[str, float]:
        """Per-step means (plus the stall per commit), for reporting."""
        n = max(self.steps, 1)
        return {
            "steps": self.steps,
            "data_wait_s": self.data_wait / n,
            "h2d_stage_s": self.h2d_stage / n,
            "device_step_s": self.device_step / n,
            "ckpt_commits": self.ckpt_commits,
            "ckpt_stall_s_per_commit": (self.ckpt_stall / self.ckpt_commits
                                        if self.ckpt_commits else 0.0),
        }


@dataclass
class LoopResult:
    final_path: Optional[Path]
    last_committed: Optional[CheckpointInfo]
    preempted: bool
    total_steps: int
    stream_pos: int
    state: Any = None  # the train state the loop ended with
    timings: StepTimeBreakdown = field(default_factory=StepTimeBreakdown)

    @property
    def path(self) -> Path:
        """The emergency checkpoint when preempted, else the final one."""
        if self.preempted and self.last_committed is not None:
            return Path(self.last_committed.path)
        return self.final_path


def add_loop_args(parser: argparse.ArgumentParser) -> None:
    """The pipelined-loop and non-finite-guard flags of every trainer."""
    parser.add_argument("--no_nan_guard", action="store_true",
                        help="disable the non-finite guard (skip-updates-on-NaN protection)")
    parser.add_argument("--max_skipped_steps", type=int, default=10,
                        help="abort after this many consecutive non-finite (skipped) steps")
    parser.add_argument(
        "--prefetch_depth", type=int, default=2,
        help="staging buffer depth: a background thread stages batch N+1 for the device "
        "while step N computes (0 = synchronous staging)")
    parser.add_argument(
        "--async_ckpt", action=argparse.BooleanOptionalAction, default=True,
        help="commit periodic checkpoints on a background thread from a host snapshot; "
        "emergency and final checkpoints are always synchronous")


def resume_state(resume: str, ckpt_dir: Path, target):
    """Resolve ``--resume`` and restore: ``(state, manifest, path)``, with
    ``path`` '' (and ``state is target``) when there is nothing to resume.
    ``auto`` restores the newest valid checkpoint under ``ckpt_dir`` in one
    read of its payload; a path restores that checkpoint."""
    if resume != "auto":
        return restore_train_state(resume, target), read_manifest(resume), resume
    hit = restore_latest_verified(str(ckpt_dir), target)
    if hit is None:
        logger.info("--resume auto: no valid checkpoint under %s; starting fresh", ckpt_dir)
        return target, None, ""
    info, state, manifest = hit
    logger.info("--resume auto: restored newest valid checkpoint %s (step %d, %s)",
                info.path, info.step, info.tag)
    return state, manifest, info.path


def _write_heartbeat(run_dir: str, fields: dict) -> None:
    """Atomically replace ``<run_dir>/heartbeat.json`` (tmp, fsync, rename)."""
    hb = {"t_wall": time.time(), "t_mono": time.monotonic(), "host": 0, **fields}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        hb["device_memory"] = {"bytes_in_use": torch.cuda.memory_allocated(),
                               "peak_bytes_in_use": torch.cuda.max_memory_allocated()}
    path = os.path.join(run_dir, HEARTBEAT_NAME)
    tmp = path + ".tmp"
    os.makedirs(run_dir, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(hb, f, indent=1, sort_keys=True, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def run_training_loop(
    *,
    state,
    step_fn: Callable[[Any, Any], Any],
    loader=None,
    batches: Optional[Iterable] = None,
    stage_fn: Callable[[Dict[str, Any]], Any],
    ckpt_dir: Path,
    name: str,
    num_steps: int,
    validation_frequency: int = 10_000,
    keep_ckpts: int = 3,
    mlog=None,
    guard=None,
    resumed: bool = False,
    resume_manifest: Optional[dict] = None,
    stream_pos: int = 0,
    stream_geometry: Optional[dict] = None,
    prefetch_depth: int = 2,
    async_ckpt: bool = True,
    validate_fn: Optional[Callable[[int, Any], None]] = None,
    run_dir: Optional[str] = None,
    heartbeat_every_s: float = 30.0,
) -> LoopResult:
    """Run the loop to ``num_steps`` (or a preemption).

    ``state`` carries the optimizer step (``state.step`` or
    ``state['step']``); ``step_fn(state, staged_batch) -> (state,
    metrics)``. Batches come from ``loader.stream(stream_pos)`` or, for
    harnesses, an explicit ``batches`` iterable. Each step's time is taken
    after the card has finished it. The caller owns the model and
    optimizer, the resume restore (``resume_state``) and ``mlog.close()``."""
    ckpt_dir = Path(ckpt_dir)
    total_steps = start_steps = _state_step(state)
    if (resumed and resume_manifest is not None and stream_geometry is not None
            and resume_manifest.get("stream_geometry") not in (None, stream_geometry)):
        logger.warning("resume: loader geometry changed %s -> %s; the data stream continues "
                       "only approximately from the interrupted position",
                       resume_manifest["stream_geometry"], stream_geometry)

    def ckpt_extra() -> dict:
        extra = {"stream_pos": stream_pos}
        if stream_geometry is not None:
            extra["stream_geometry"] = stream_geometry
        return extra

    timings = StepTimeBreakdown()
    preempted = False
    last_committed: Optional[CheckpointInfo] = None
    # a resumed run that already reached num_steps trains no extra step
    should_keep_training = total_steps < num_steps
    committer = AsyncCheckpointer() if async_ckpt and should_keep_training else None
    stager = None
    if should_keep_training:
        stream = iter(batches) if batches is not None else loader.stream(stream_pos)
        if prefetch_depth > 0:
            stager = DeviceStager(stream, stage_fn, depth=prefetch_depth, start_step=total_steps)
        else:
            stager = _SyncStager(stream, stage_fn, start_step=total_steps)

    def sync_commit(tag: str) -> CheckpointInfo:
        return commit_checkpoint(str(ckpt_dir / f"{total_steps}_{name}"), state,
                                 step=total_steps, tag=tag, extra=ckpt_extra())

    t_loop0 = time.monotonic()
    last_hb = [0.0]

    def write_heartbeat(force: bool = False) -> None:
        """Run-health snapshot, at most every ``heartbeat_every_s`` (forced
        at the first step, a preemption and the end)."""
        now = time.monotonic()
        if run_dir is None or (not force and now - last_hb[0] < heartbeat_every_s):
            return
        last_hb[0] = now
        dt = now - t_loop0
        rate = (total_steps - start_steps) / dt if dt > 0 else 0.0
        _write_heartbeat(run_dir, {
            "name": name, "step": total_steps, "num_steps": num_steps,
            "steps_per_s": round(rate, 4),
            "eta_s": (round((num_steps - total_steps) / rate, 1)
                      if rate > 0 and total_steps < num_steps else 0.0),
            "last_ckpt": ({"step": last_committed.step, "tag": last_committed.tag,
                           "path": last_committed.path}
                          if last_committed is not None else None),
            "skipped_steps": guard.total_skipped if guard is not None else 0,
            "consecutive_skipped": guard.consecutive if guard is not None else 0,
            "quarantined": len(getattr(loader, "quarantined", ())) if loader is not None else 0,
            "preempted": preempted,
        })

    pending_stall = 0.0  # last commit's loop-thread stall, logged with the next step
    try:
        with GracefulShutdown() as stopper:
            while should_keep_training:
                item = stager.get()
                if item is None:  # a finite harness stream is exhausted
                    break
                staged, stage_s, wait_s = item
                t0 = time.perf_counter()
                state, metrics = step_fn(state, staged)
                if torch.cuda.is_initialized():
                    # the guard already waits for the card once a step (its
                    # finiteness flag); waiting again here costs the
                    # update's tail and makes each step's time its own
                    torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
                total_steps += 1
                stream_pos += 1
                timings.add(wait_s, stage_s, step_s)
                write_heartbeat(force=timings.steps == 1)
                if mlog is not None:
                    mlog.push(total_steps, metrics,
                              timing={"data_wait": wait_s, "h2d_stage": stage_s,
                                      "device_step": step_s, "ckpt_stall": pending_stall})
                    pending_stall = 0.0
                if guard is not None:
                    guard.observe(total_steps, metrics.get("skipped", 0.0))
                faultinject.maybe_sigterm(total_steps)
                if committer is not None:
                    committer.poll()  # surface async-commit failures promptly

                if stopper.should_stop:
                    # join the in-flight periodic commit, then commit the
                    # emergency checkpoint at this step boundary
                    if committer is not None:
                        try:
                            committer.join()
                        except Exception:
                            logger.exception("in-flight periodic commit failed during "
                                             "preemption; attempting the emergency commit")
                    last_committed = sync_commit("emergency")
                    if mlog is not None:
                        mlog.flush()
                    logger.warning("preempted: emergency checkpoint at step %d committed to %s "
                                   "— restart with --resume auto to continue", total_steps,
                                   last_committed.path)
                    preempted = True
                    break

                if total_steps % validation_frequency == 0:
                    t_ck = time.perf_counter()
                    if committer is not None:
                        last_committed = committer.commit_async(
                            str(ckpt_dir / f"{total_steps}_{name}"), state, step=total_steps,
                            extra=ckpt_extra(), rotate_dir=str(ckpt_dir), keep=keep_ckpts)
                    else:
                        last_committed = sync_commit("periodic")
                        rotate_checkpoints(str(ckpt_dir), keep=keep_ckpts)
                    stall_s = time.perf_counter() - t_ck
                    timings.stall(stall_s)
                    pending_stall += stall_s
                    if validate_fn is not None:
                        validate_fn(total_steps, state)

                if total_steps >= num_steps:
                    break

        if guard is not None:
            guard.check()  # surface a pending skip streak before success
        if committer is not None:
            committer.join()  # the final/dedupe logic below needs it durable
        if preempted:
            return LoopResult(final_path=None, last_committed=last_committed, preempted=True,
                              total_steps=total_steps, stream_pos=stream_pos, state=state,
                              timings=timings)

        final = ckpt_dir / name
        existing_final = read_manifest(str(final))
        if last_committed is not None and last_committed.step == total_steps:
            clone_checkpoint(last_committed.path, str(final), tag="final")
            logger.info("final checkpoint %s deduped from step checkpoint %s (step %d)",
                        final, last_committed.path, total_steps)
        elif (resumed and total_steps == start_steps and existing_final is not None
              and existing_final.get("step") == total_steps
              and verify_checkpoint(str(final), existing_final)):
            logger.info("final checkpoint %s already committed at step %d; left as-is",
                        final, total_steps)
        else:
            commit_checkpoint(str(final), state, step=total_steps, tag="final",
                              extra=ckpt_extra())
        return LoopResult(final_path=final, last_committed=last_committed, preempted=False,
                          total_steps=total_steps, stream_pos=stream_pos, state=state,
                          timings=timings)
    finally:
        if stager is not None:
            stager.close()
        if committer is not None:
            try:
                committer.close()
            except Exception:
                logger.exception("async checkpoint committer failed at close")
        try:
            write_heartbeat(force=True)
        except Exception:  # noqa: BLE001 — never mask the real exit
            logger.exception("final heartbeat write failed")


__all__ = [
    "AsyncCheckpointer",
    "DeviceStager",
    "LoopResult",
    "StagedBatch",
    "StepTimeBreakdown",
    "add_loop_args",
    "cpu_stage_fn",
    "cuda_stage_fn",
    "resume_state",
    "run_training_loop",
    "unstage",
]
