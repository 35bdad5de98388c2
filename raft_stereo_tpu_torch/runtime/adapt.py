"""Online-adaptation serving: MAD as a service on the inference engine
(PyTorch port of ``raft_stereo_tpu/runtime/adapt.py``).

A long-running stream of requests is served by the batched engine
(``runtime/infer.py``) while MAD adaptation steps run between request
chunks on the same card, so the model tracks domains its training set
never saw, behind rails that degrade a bad step to frozen serving instead
of a corrupted model:

  * ``make_adapt_step``: the one MAD adaptation step (``train_mad`` uses it
    too): block-isolated gradients (the model's ``mad`` detaches), the
    update through ``guard.apply_or_skip`` when guarded (a NaN step leaves
    parameters and both Adam moments untouched), and optionally the serving
    *proxy loss* (the self-supervised photometric loss of the finest
    full-resolution prediction, comparable whichever block was sampled) in
    the same forward. ``make_proxy_fn`` computes that proxy without
    gradients, for frozen serving.
  * ``ProxyLossMonitor``: a fast EMA of the proxy against a slow one; a
    fast EMA past ``regress_factor`` × the slow one is a regression.
  * ``AdaptPolicy``: ``every_n`` adapts at every opportunity (one per
    ``every`` served requests), ``on_degrade`` only while the fast EMA is
    past ``degrade_factor`` × the best seen.
  * ``AdaptiveServer``: streams each chunk through the engine, remembers the
    last served pair on the stager thread as it resolves (no second decode),
    and between chunks runs the policy's steps on it.

**The served weights are not the adapting weights.** On the card the
engine's captured graphs read the served module's parameters by address,
so an optimizer step in place on that module would serve a step that has
not passed the rails yet, and a rollback could not take back what was
served. The server trains ``state.model``, a separate copy, and pushes its
weights into the served module with ``InferenceEngine.update_variables``
only once a step has passed (and after a rollback), between chunks, with
no new capture.

Rails, each proven by a fault injector (``RAFT_FI_ADAPT_NAN``,
``RAFT_FI_ADAPT_REGRESS``): a guard-skipped step (``adapt_skip``), and
``max_adapt_skips`` of them in a row roll back; a regression
(``adapt_regress``) discards its step and rolls back; a rollback restores
the newest snapshot that verifies (``runtime/checkpoint.py``: manifested,
CRC-checked, rotated; ``adapt_rollback``); past ``max_rollbacks``
adaptation freezes (``adapt_frozen``) and serving goes on with the last good
weights. No request is ever failed by adaptation.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.losses import self_supervised_loss
from raft_stereo_tpu_torch.models.madnet2 import (
    DIVIS_BY,
    MADController,
    adaptation_loss,
    nearest_up2,
)
from raft_stereo_tpu_torch.ops.pad import InputPadder
from raft_stereo_tpu_torch.parallel.train_step import apply_update
from raft_stereo_tpu_torch.runtime import blackbox
from raft_stereo_tpu_torch.runtime import checkpoint as ckpt
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferRequest, InferResult

logger = logging.getLogger(__name__)


def _fmt_exc(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e)[:200]}"


def upsample_predictions(pred_disps, padder: InputPadder) -> List[torch.Tensor]:
    """Each level nearest-upsampled ×2^(i+2), scaled ×−20 and unpadded
    (reference train_mad.py:246-253); channel-last."""
    out = []
    for i, d in enumerate(pred_disps):
        for _ in range(i + 2):
            d = nearest_up2(d)
        out.append(padder.unpad(d * -20.0))
    return out


def _serving_proxy(full_preds, batch) -> torch.Tensor:
    """The serving-health metric: the self-supervised photometric loss of
    the finest full-resolution prediction."""
    return self_supervised_loss(full_preds[0], batch["img1"], batch["img2"])


def _mad_forward(model, batch, mad: bool):
    padder = InputPadder(batch["img1"].shape, divis_by=DIVIS_BY)
    img1, img2 = padder.pad(batch["img1"], batch["img2"])
    return upsample_predictions(model(img1, img2, mad=mad), padder)


def make_adapt_step(adapt_mode: str, *, guard: bool = False, with_proxy: bool = False):
    """``step(state, batch, idx) -> (state, info)``: one adaptation step on
    ``state`` (a ``parallel.train_step.TrainState``: the adapting model, its
    optimizer and schedule), in place. ``idx`` is the sampled block (−1 for
    the all-block modes). Every parameter gets a gradient, zero where the
    block isolation leaves none, as ``jax.grad`` gives, so the optimizer
    moves every parameter on its moments as optax does.

    ``info``: ``loss`` (the objective) and ``proxy`` (the serving proxy
    with ``with_proxy``, else the loss), detached scalar tensors, and
    ``finite`` (False when the guard skipped the update)."""

    def step(state, batch, idx: int):
        state.optimizer.zero_grad(set_to_none=True)
        full = _mad_forward(state.model, batch, mad=True)
        loss, _ = adaptation_loss(batch["img1"], batch["img2"], full, batch.get("flow"),
                                  batch.get("valid"), adapt_mode, idx)
        proxy = _serving_proxy(full, batch).detach() if with_proxy else loss.detach()
        loss.backward()
        state, metrics = apply_update(state, loss, {}, nonfinite_guard=guard)
        finite = float(metrics.get("skipped", 0.0)) == 0.0
        return state, {"loss": loss.detach(), "proxy": proxy, "finite": finite}

    return step


def make_proxy_fn():
    """``proxy(model, batch)``: the serving proxy of ``model`` on ``batch``,
    without gradients (frozen serving's health signal)."""

    def proxy(model, batch) -> torch.Tensor:
        with torch.no_grad():
            return _serving_proxy(_mad_forward(model, batch, mad=False), batch)

    return proxy


class ProxyLossMonitor:
    """EMA-based quality-regression detector over the serving proxy.

    ``update(value)`` folds one observation and returns True when the fast
    EMA exceeds ``regress_factor`` × the slow EMA. The first ``warmup``
    observations only seed the EMAs. ``reset()`` re-seeds after a rollback.
    """

    def __init__(self, regress_factor: float = 2.0, fast_alpha: float = 0.5,
                 slow_alpha: float = 0.1, warmup: int = 2):
        if regress_factor <= 1.0:
            raise ValueError("regress_factor must be > 1")
        if not 0 < slow_alpha <= fast_alpha <= 1:
            raise ValueError("need 0 < slow_alpha <= fast_alpha <= 1")
        self.regress_factor = float(regress_factor)
        self.fast_alpha = float(fast_alpha)
        self.slow_alpha = float(slow_alpha)
        self.warmup = int(warmup)
        self.reset()

    def reset(self) -> None:
        self.ema_fast: Optional[float] = None
        self.ema_slow: Optional[float] = None
        self.best_fast: Optional[float] = None
        self.count = 0

    def update(self, value: float) -> bool:
        """Fold one proxy observation; True = regression detected. A
        non-finite value is the guard's business and is not folded."""
        value = float(value)
        if not np.isfinite(value):
            return False
        self.count += 1
        if self.ema_fast is None:
            self.ema_fast = self.ema_slow = value
        else:
            self.ema_fast += self.fast_alpha * (value - self.ema_fast)
            self.ema_slow += self.slow_alpha * (value - self.ema_slow)
        if self.best_fast is None or self.ema_fast < self.best_fast:
            self.best_fast = self.ema_fast
        if self.count <= self.warmup:
            return False
        return self.ema_fast > self.regress_factor * self.ema_slow

    def degraded(self, factor: float) -> bool:
        """Has the fast EMA degraded past ``factor`` × the best seen (the
        ``on_degrade`` trigger)? False until the warmup has observations."""
        if self.count < self.warmup or self.best_fast is None:
            return False
        return self.ema_fast > factor * self.best_fast


@dataclass(frozen=True)
class AdaptPolicy:
    """When the server takes an adaptation opportunity: one arises per
    ``every`` served requests (rounded up to a multiple of the engine's
    micro-batch); ``every_n`` takes all, ``on_degrade`` evaluates the frozen
    proxy first and adapts only while quality has degraded past
    ``degrade_factor`` × the best fast EMA seen."""

    mode: str = "every_n"  # "every_n" | "on_degrade"
    every: int = 1
    degrade_factor: float = 1.2

    def __post_init__(self):
        if self.mode not in ("every_n", "on_degrade"):
            raise ValueError(f"unknown AdaptPolicy mode {self.mode!r}")
        if self.every < 1:
            raise ValueError("AdaptPolicy.every must be >= 1")


@dataclass
class AdaptConfig:
    """The adaptive server's rails and cadence."""

    adapt_mode: str = "mad"          # 'mad' | 'full' (the modes without GT)
    adapt: bool = True               # False: frozen serving (--no_adapt)
    policy: AdaptPolicy = field(default_factory=AdaptPolicy)
    steps_per_opportunity: int = 1
    snapshot_every: int = 4          # healthy steps between good snapshots
    keep_snapshots: int = 2
    max_adapt_skips: int = 3         # consecutive guard skips -> rollback
    max_rollbacks: int = 3           # then adaptation freezes
    regress_factor: float = 2.0
    regress_warmup: int = 2
    seed: int = 0                    # MADController's block-sampling seed


class AdaptiveServer:
    """Serve a request stream while adapting the model online.

    ``engine`` serves its ``module``; ``state`` (a ``TrainState``) holds the
    adapting copy, which must be a separate module with the served one's
    weights, its optimizer and schedule; the server owns and updates it in
    place. ``adapt_step_fn`` / ``proxy_fn`` may be passed pre-built;
    ``stream_fn`` routes the requests (``engine.stream`` by default, the
    scheduler's ``serve`` under ``--sched``); ``should_stop`` (a drain in
    progress) skips every remaining opportunity.

    ``serve(requests)`` yields ``InferResult``s as ``engine.stream`` does;
    ``summary()`` reports the adaptation's accounting."""

    def __init__(self, engine: InferenceEngine, state, snapshot_dir: str,
                 config: Optional[AdaptConfig] = None, *, name: str = "serve",
                 adapt_step_fn: Optional[Callable] = None, proxy_fn: Optional[Callable] = None,
                 stream_fn: Optional[Callable] = None,
                 should_stop: Optional[Callable[[], bool]] = None):
        self.config = config or AdaptConfig()
        if self.config.adapt_mode not in ("mad", "full"):
            raise ValueError(
                "serving adaptation is self-supervised: adapt_mode must be 'mad' or 'full' "
                f"(the ++ modes need GT), got {self.config.adapt_mode!r}")
        if state is not None and (engine.module is None or engine.module is state.model):
            raise ValueError("the adapting state's model must be a separate copy of the "
                             "engine's served module (update_variables pushes between them)")
        self.engine = engine
        self.state = state
        self.snapshot_dir = str(snapshot_dir)
        self.name = name
        self._single_block = self.config.adapt_mode == "mad"
        self.controller = MADController(seed=self.config.seed)
        self.monitor = ProxyLossMonitor(regress_factor=self.config.regress_factor,
                                        warmup=self.config.regress_warmup)
        self._stream_fn = stream_fn or engine.stream
        self._should_stop = should_stop or (lambda: False)
        self._every = int(self.config.policy.every)
        self._step = adapt_step_fn or make_adapt_step(self.config.adapt_mode, guard=True,
                                                      with_proxy=True)
        self._proxy = proxy_fn or make_proxy_fn()
        self._device = engine.device  # the adapting copy lives beside the served one
        self._pair_lock = threading.Lock()
        self._last_pair: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.adapt_steps = 0       # applied (healthy) steps
        self.adapt_skips = 0       # guard-skipped steps
        self.consecutive_skips = 0
        self.regressions = 0
        self.rollbacks = 0
        self.snapshots = 0
        self.holds = 0             # on_degrade opportunities not taken
        self.frozen = False
        self.proxy_history: List[float] = []
        self.step_seconds: List[float] = []  # wall time of each attempted step
        blackbox.register_provider("adapt", self.snapshot)
        if self.config.adapt:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            # rollback targets never cross server lifetimes: this server's
            # old snapshots (kind=adapt_good) are cleared; a directory that
            # holds any other checkpoint is refused, never cleared
            stale, foreign = [], []
            for info in ckpt.list_checkpoints(self.snapshot_dir):
                m = ckpt.read_manifest(info.path) or {}
                (stale if m.get("kind") == "adapt_good" else foreign).append(info)
            if foreign:
                raise ValueError(
                    f"snapshot_dir {self.snapshot_dir!r} contains {len(foreign)} checkpoint(s) "
                    f"this server did not write (e.g. step {foreign[0].step} at "
                    f"{foreign[0].path!r}): refusing to manage (and rotate or delete) a "
                    "directory holding other checkpoints; point --snapshot_dir at a "
                    "dedicated directory")
            if stale:
                logger.warning("clearing %d stale adaptation snapshot(s) from %s", len(stale),
                               self.snapshot_dir)
                for info in stale:
                    ckpt.delete_checkpoint(info.path)
            # the rollback floor: the entry weights served before any step
            self._commit_snapshot()

    # ------------------------------------------------------------ actuator

    def set_every(self, every: int) -> None:
        """The overload controller's actuator: the adaptation cadence
        (served requests per opportunity), >= 1. The serve loop reads it
        once a chunk, so it takes effect at the next chunk."""
        every = int(every)
        if every < 1:
            raise ValueError("adaptation cadence (every) must be >= 1")
        self._every = every

    # ------------------------------------------------------------- serving

    def serve(self, requests: Iterable[InferRequest]) -> Iterator[InferResult]:
        """Stream ``requests`` through the engine in chunks, adapting between
        them. With adaptation off (or frozen) each chunk still evaluates the
        frozen proxy, and the served outputs are exactly a plain
        ``engine.stream``'s over the same chunks."""
        it = iter(requests)
        b = self.engine.batch
        while True:
            # one cadence read a chunk, rounded up to whole micro-batches
            chunk = list(itertools.islice(it, ((self._every + b - 1) // b) * b))
            if not chunk:
                break
            yield from self._stream_fn(self._wrap(r) for r in chunk)
            if not self._should_stop():
                self._adapt_opportunity()
            self._write_heartbeat()

    def _wrap(self, req) -> InferRequest:
        """Remember each request's resolved pair, on the thread that resolves
        it, after the engine's own validation (a malformed request becomes
        the engine's error result, never an adaptation batch). A
        ``SchedRequest`` is unwrapped: the server serves fixed chunks."""
        base = getattr(req, "request", req)
        inner, payload = base.inputs, base.payload

        def resolve(inner=inner, payload=payload):
            arrays = InferRequest(payload=payload, inputs=inner).resolve()
            if len(arrays) >= 2:
                with self._pair_lock:
                    self._last_pair = (arrays[0], arrays[1])
            return arrays

        return InferRequest(payload=payload, inputs=resolve,
                            trace_id=getattr(base, "trace_id", None))

    def _take_pair(self) -> Optional[Dict[str, torch.Tensor]]:
        with self._pair_lock:
            pair = self._last_pair
        if pair is None:
            return None
        return {k: torch.as_tensor(np.asarray(a), dtype=torch.float32)[None].to(self._device)
                for k, a in zip(("img1", "img2"), pair)}

    # ---------------------------------------------------------- adaptation

    def _adapt_opportunity(self) -> None:
        """One opportunity, a serving pause (``adapt_pause``,
        ``serve_pause_seconds``). An unexpected failure freezes adaptation;
        the stream goes on."""
        steps_before = self.adapt_steps
        t0 = time.perf_counter()
        try:
            with telemetry.span("adapt_pause"):
                self._adapt_opportunity_inner()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — serving outlives adaptation
            logger.exception("adaptation opportunity failed (%s): freezing adaptation, "
                             "serving continues frozen", _fmt_exc(e))
            telemetry.emit("adapt_error", step=self.state.step, error=_fmt_exc(e))
            self._freeze(f"adapt_error: {type(e).__name__}")
        finally:
            pause_s = time.perf_counter() - t0
            telemetry.observe("serve_pause_seconds", pause_s)
            telemetry.emit("adapt_pause", pause_ms=round(pause_s * 1e3, 1),
                           took=self.adapt_steps > steps_before)

    def _adapt_opportunity_inner(self) -> None:
        batch = self._take_pair()
        if batch is None:  # nothing resolved yet (every request failed)
            return
        if not (self.config.adapt and not self.frozen):
            self._record_eval(batch)
            return
        if self.config.policy.mode == "on_degrade":
            proxy = self._record_eval(batch)
            if proxy is None or not self.monitor.degraded(self.config.policy.degrade_factor):
                self.holds += 1
                telemetry.emit("adapt_hold", step=self.state.step, proxy=proxy,
                               ema_fast=self.monitor.ema_fast, best_fast=self.monitor.best_fast)
                return
        for _ in range(self.config.steps_per_opportunity):
            if self.frozen:
                break
            self._adapt_once(batch)

    def _record_eval(self, batch) -> Optional[float]:
        """A frozen proxy observation (no update)."""
        proxy = float(self._proxy(self.state.model, batch))
        if np.isfinite(proxy):
            self.proxy_history.append(proxy)
            self.monitor.update(proxy)
        telemetry.emit("adapt_eval", step=self.state.step, proxy=proxy,
                       frozen=self.frozen or not self.config.adapt)
        return proxy if np.isfinite(proxy) else None

    def _adapt_once(self, batch) -> None:
        t0 = time.perf_counter()
        if faultinject.adapt_nan_point():
            batch = dict(batch, img1=torch.full_like(batch["img1"], float("nan")))
        idx = self.controller.sample_block() if self._single_block else self.controller.sample_all()
        self.state, info = self._step(self.state, batch, int(idx))
        # one host read for both scalars
        loss, proxy = torch.stack([info["loss"].float(), info["proxy"].float()]).tolist()
        dt = time.perf_counter() - t0
        self.step_seconds.append(dt)
        telemetry.observe("adapt_step_seconds", dt)
        if not info["finite"]:
            # the guard skipped the update: weights and moments untouched (the
            # step counter advanced); a streak rolls back
            self.adapt_skips += 1
            self.consecutive_skips += 1
            logger.warning("adaptation step skipped (non-finite loss/grads; %d consecutive)",
                           self.consecutive_skips)
            telemetry.emit("adapt_skip", step=self.state.step,
                           consecutive=self.consecutive_skips, block=int(idx))
            if self.consecutive_skips >= self.config.max_adapt_skips:
                self._rollback("nan_streak")
            return
        self.consecutive_skips = 0
        proxy = faultinject.adapt_regress_point(proxy)
        if self._single_block:
            self.controller.update_sample_distribution(int(idx), loss)
        regressed = self.monitor.update(proxy)
        self.proxy_history.append(proxy)
        telemetry.emit("adapt_step", step=self.state.step, block=int(idx), loss=loss,
                       proxy=proxy, ema_fast=self.monitor.ema_fast,
                       ema_slow=self.monitor.ema_slow)
        if regressed:
            # the step made serving measurably worse: never served, it is
            # discarded by the rollback
            self.regressions += 1
            logger.error("adaptation quality regression: proxy %.4f, fast EMA %.4f > %.2f x "
                         "slow EMA %.4f: rolling back", proxy, self.monitor.ema_fast,
                         self.config.regress_factor, self.monitor.ema_slow)
            telemetry.emit("adapt_regress", step=self.state.step, proxy=proxy,
                           ema_fast=self.monitor.ema_fast, ema_slow=self.monitor.ema_slow,
                           factor=self.config.regress_factor)
            self._rollback("regression")
            return
        self.adapt_steps += 1
        self.engine.update_variables(self.state.model.state_dict())
        if self.adapt_steps % self.config.snapshot_every == 0:
            self._commit_snapshot()

    # ------------------------------------------------- snapshots + rollback

    def _commit_snapshot(self) -> None:
        """Commit the current (rails-passed) state as a manifested, CRC'd
        checkpoint, the rollback target; rotation keeps ``keep_snapshots``."""
        step = int(self.state.step)
        info = ckpt.commit_checkpoint(
            os.path.join(self.snapshot_dir, f"{step}_{self.name}"), self.state, step=step,
            tag="periodic", extra={"kind": "adapt_good", "proxy_ema": self.monitor.ema_fast,
                                   "adapt_steps": self.adapt_steps})
        ckpt.rotate_checkpoints(self.snapshot_dir, keep=self.config.keep_snapshots)
        self.snapshots += 1
        telemetry.emit("adapt_snapshot", step=step, path=info.path, adapt_steps=self.adapt_steps)

    def _rollback(self, reason: str) -> None:
        """Restore the newest snapshot that verifies into the state, push it
        to the engine; freeze past ``max_rollbacks``."""
        restored = ckpt.restore_latest_verified(self.snapshot_dir, self.state)
        self.rollbacks += 1
        self.consecutive_skips = 0
        self.monitor.reset()
        if restored is None:
            # no verifiable snapshot: the served weights are the last that
            # passed the rails (a regressed step changed the state in place)
            self.state.model.load_state_dict(self.engine.module.state_dict())
            logger.error("rollback (%s) found no verifiable snapshot in %s: freezing "
                         "adaptation on the served weights", reason, self.snapshot_dir)
            telemetry.emit("adapt_rollback", step=self.state.step, reason=reason,
                           restored=False)
            self._freeze("no_verifiable_snapshot")
            return
        info, self.state, _ = restored
        self.engine.update_variables(self.state.model.state_dict())
        logger.warning("rolled back (%s) to snapshot step %d (%s): serving continues on the "
                       "last good weights", reason, info.step, info.path)
        telemetry.emit("adapt_rollback", step=self.state.step, reason=reason, restored=True,
                       snapshot_step=info.step, path=info.path)
        if self.rollbacks >= self.config.max_rollbacks:
            self._freeze(f"max_rollbacks ({self.config.max_rollbacks})")

    def freeze(self, reason: str) -> None:
        """The public freeze rail (the quality observatory's canary latch
        calls it): the same path ``max_rollbacks`` takes."""
        self._freeze(reason)

    def _freeze(self, reason: str) -> None:
        if self.frozen:
            return
        self.frozen = True
        logger.error("adaptation frozen (%s): the stream keeps serving on the last good "
                     "weights", reason)
        telemetry.emit("adapt_frozen", step=self.state.step, reason=reason)
        blackbox.request_dump("adapt_frozen", reason)

    # ------------------------------------------------------------ reporting

    def _write_heartbeat(self) -> None:
        tel = telemetry.get()
        if tel is None:
            return
        tel.write_heartbeat(
            mode="serve_adaptive", requests=self.engine.stats.images,
            failed_requests=self.engine.stats.failed, adapt_steps=self.adapt_steps,
            adapt_skips=self.adapt_skips, rollbacks=self.rollbacks, snapshots=self.snapshots,
            adapt_frozen=self.frozen,
            proxy_last=self.proxy_history[-1] if self.proxy_history else None,
            proxy_ema_fast=self.monitor.ema_fast, proxy_ema_slow=self.monitor.ema_slow)

    def snapshot(self) -> Dict[str, Any]:
        """The rails' live state (the blackbox provider)."""
        return {
            "frozen": self.frozen, "adapt": self.config.adapt, "every": self._every,
            "adapt_steps": self.adapt_steps, "adapt_skips": self.adapt_skips,
            "consecutive_skips": self.consecutive_skips, "regressions": self.regressions,
            "rollbacks": self.rollbacks, "snapshots": self.snapshots, "holds": self.holds,
            "proxy_last": self.proxy_history[-1] if self.proxy_history else None,
            "proxy_ema_fast": self.monitor.ema_fast, "proxy_ema_slow": self.monitor.ema_slow,
        }

    def summary(self) -> Dict[str, Any]:
        """The adaptation's accounting of the served stream (the request
        ledger is the engine's ``stats``)."""
        hist = self.proxy_history
        half = len(hist) // 2
        return {
            "served": self.engine.stats.images,
            "failed": self.engine.stats.failed,
            "adapt_steps": self.adapt_steps,
            "adapt_skips": self.adapt_skips,
            "regressions": self.regressions,
            "rollbacks": self.rollbacks,
            "snapshots": self.snapshots,
            "holds": self.holds,
            "frozen": self.frozen,
            "proxy_first": hist[0] if hist else None,
            "proxy_last": hist[-1] if hist else None,
            "proxy_mean_first_half": float(np.mean(hist[:half])) if half else None,
            "proxy_mean_second_half": float(np.mean(hist[half:])) if half else None,
            "controller_distribution": [round(float(x), 4)
                                        for x in self.controller.sample_distribution],
        }


__all__ = [
    "AdaptConfig",
    "AdaptPolicy",
    "AdaptiveServer",
    "ProxyLossMonitor",
    "make_adapt_step",
    "make_proxy_fn",
    "upsample_predictions",
]
