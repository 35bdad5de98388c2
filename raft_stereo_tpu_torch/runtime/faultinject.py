"""Deterministic fault injection for the runtime (the port's own copy of
the training, IO, serving, serving-lifecycle and adaptation points of
``raft_stereo_tpu/runtime/faultinject.py``).

Each injection point is a no-op unless armed, through an environment
variable (so a fault can be planted across the process boundary of a CLI
run) or programmatically with ``arm()`` (which wins over the environment):

  ``RAFT_FI_NAN_STEP``      1-indexed training step whose batch is
                            NaN-poisoned by the loop's stager
  ``RAFT_FI_SIGTERM_STEP``  1-indexed training step after which SIGTERM is
                            delivered to this process (once)
  ``RAFT_FI_CRASH``         name of a ``crash_point`` to trip: the
                            checkpoint layer declares ``ckpt_commit``
                            (payload written, before its rename) and
                            ``manifest_commit`` (manifest written, before
                            its rename), the telemetry sink
                            ``heartbeat_write`` (heartbeat written, before
                            its rename)
  ``RAFT_FI_IO_FAIL_READS`` comma list of 1-indexed global read-attempt
                            ordinals of ``data/frame_io`` that raise
                            ``OSError``

Serving points (``runtime/infer.py``; each proves one of the engine's
recovery paths):

  ``RAFT_FI_INFER_DECODE_FAIL``  comma list of 1-indexed decode ordinals
                                 (one a request the stager pulls) that raise
                                 ``OSError``: the request fails alone
  ``RAFT_FI_INFER_COMPILE_FAIL`` comma list of 1-indexed ordinals of the
                                 engine's "compiles" (a warm-up and capture
                                 of a new graph key on the card, a key's
                                 first eager run on the CPU) that raise
                                 ``RuntimeError``: one proves the retry,
                                 more than the retry budget the circuit
                                 breaker and the degraded path
  ``RAFT_FI_INFER_OOM``          int: every device wait whose micro-batch
                                 is at least this raises
                                 ``torch.cuda.OutOfMemoryError``, the type a
                                 real one has: the batch halves until it fits
  ``RAFT_FI_INFER_HANG``         comma list of 1-indexed device-wait
                                 ordinals that block until ``reset()``: the
                                 watchdog trips

Serving-lifecycle points (``runtime/scheduler.py``):

  ``RAFT_FI_SCHED_STALL``        ``ORDINALS[:MS]``: comma list of 1-indexed
                                 scheduler dispatch-loop passes (one a
                                 ``_next_group`` call) that sleep MS
                                 milliseconds (default 200) first, so the
                                 admission queue builds up without timing
                                 races (shedding, drain expiry)
  ``RAFT_FI_SCHED_STALL_SCOPE``  the label (tier) of the one scheduler that
                                 stalls; its ordinals then count that
                                 scheduler's own passes
  ``RAFT_FI_WARM_POISON``        ``ORDINALS[:FILL]``: comma list of 1-indexed
                                 warm-start reuses (one a session frame that
                                 warm-starts) whose warm slot is replaced by
                                 the constant FILL (default 40.0 px): a stale
                                 prior, which the refinement really starts
                                 from

Adaptation-serving points (``runtime/adapt.py``; each proves one of the
adaptive server's rails):

  ``RAFT_FI_ADAPT_NAN``          comma list of 1-indexed adaptation-step
                                 attempts whose batch is NaN-poisoned before
                                 the step: the guard skips the update (a
                                 streak rolls back) while every request is
                                 still served
  ``RAFT_FI_ADAPT_REGRESS``      comma list of 1-indexed applied (finite)
                                 adaptation steps whose proxy loss is
                                 inflated x10: the regression detector fires
                                 and the server rolls back

Every point is deterministic: the same arming fails the same ordinal.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Dict, Optional, Set

logger = logging.getLogger(__name__)


class InjectedCrash(RuntimeError):
    """Raised by an armed ``crash_point``."""


_armed_nan_step: Optional[int] = None
_armed_sigterm_step: Optional[int] = None
_armed_crash: Optional[str] = None
_armed_io_fail_reads: Optional[Set[int]] = None
_armed_infer_decode_fail: Optional[Set[int]] = None
_armed_infer_compile_fail: Optional[Set[int]] = None
_armed_infer_oom_batch: Optional[int] = None
_armed_infer_hang: Optional[Set[int]] = None
_armed_sched_stall: Optional[Set[int]] = None
_armed_sched_stall_ms: Optional[float] = None
_armed_sched_stall_scope: Optional[str] = None
_armed_warm_poison: Optional[Set[int]] = None
_armed_warm_poison_fill: Optional[float] = None
_armed_adapt_nan: Optional[Set[int]] = None
_armed_adapt_regress: Optional[Set[int]] = None
_sigterm_fired = False

# Attempt counters span retries and call sites; the lock keeps ordinals
# exact when several threads read.
_lock = threading.Lock()
_io_read_attempts = 0
_infer_decode_attempts = 0
_infer_compile_attempts = 0
_infer_wait_attempts = 0
_sched_dispatch_attempts = 0
# Per-scheduler dispatch passes, by the label each scheduler passes to
# ``sched_stall_point`` (its tier): a scoped stall counts its victim's own
# passes, which several interleaving dispatch loops would otherwise split.
_sched_dispatch_by_label: Dict[str, int] = {}
_warm_reuse_attempts = 0
_adapt_attempts = 0
_adapt_regress_checks = 0
# An injected hang parks the engine's device-wait thread on this event, so a
# test never sleeps past its deadline; ``reset()`` releases parked threads.
_hang_release = threading.Event()


def reset() -> None:
    """Clear programmatic arming, the counters and the once-only SIGTERM
    latch (the environment is left alone), and release any device-wait
    thread parked by an injected hang."""
    global _armed_nan_step, _armed_sigterm_step, _armed_crash, _sigterm_fired
    global _armed_io_fail_reads, _armed_infer_decode_fail, _armed_infer_compile_fail
    global _armed_infer_oom_batch, _armed_infer_hang, _hang_release
    global _armed_sched_stall, _armed_sched_stall_ms, _armed_sched_stall_scope
    global _armed_warm_poison, _armed_warm_poison_fill
    global _io_read_attempts, _infer_decode_attempts, _infer_compile_attempts
    global _infer_wait_attempts, _sched_dispatch_attempts, _sched_dispatch_by_label
    global _warm_reuse_attempts, _armed_adapt_nan, _armed_adapt_regress
    global _adapt_attempts, _adapt_regress_checks
    # under the counters' lock: a dispatch thread still bumping a counter
    # must not interleave with its reset
    with _lock:
        _armed_nan_step = _armed_sigterm_step = _armed_crash = None
        _armed_io_fail_reads = _armed_infer_decode_fail = _armed_infer_compile_fail = None
        _armed_infer_oom_batch = _armed_infer_hang = None
        _armed_sched_stall = _armed_sched_stall_ms = _armed_sched_stall_scope = None
        _armed_warm_poison = _armed_warm_poison_fill = None
        _armed_adapt_nan = _armed_adapt_regress = None
        _sigterm_fired = False
        _io_read_attempts = _infer_decode_attempts = _infer_compile_attempts = 0
        _infer_wait_attempts = _sched_dispatch_attempts = _warm_reuse_attempts = 0
        _adapt_attempts = _adapt_regress_checks = 0
        _sched_dispatch_by_label = {}
        _hang_release.set()
        _hang_release = threading.Event()


def arm(nan_step: Optional[int] = None, sigterm_step: Optional[int] = None,
        crash: Optional[str] = None, io_fail_reads: Optional[Set[int]] = None,
        infer_decode_fail: Optional[Set[int]] = None,
        infer_compile_fail: Optional[Set[int]] = None,
        infer_oom_batch: Optional[int] = None,
        infer_hang: Optional[Set[int]] = None,
        sched_stall: Optional[Set[int]] = None,
        sched_stall_ms: Optional[float] = None,
        sched_stall_scope: Optional[str] = None,
        warm_poison: Optional[Set[int]] = None,
        warm_poison_fill: Optional[float] = None,
        adapt_nan: Optional[Set[int]] = None,
        adapt_regress: Optional[Set[int]] = None) -> None:
    """Programmatic arming for in-process tests (overrides env vars)."""
    global _armed_nan_step, _armed_sigterm_step, _armed_crash, _armed_io_fail_reads
    global _armed_infer_decode_fail, _armed_infer_compile_fail, _armed_infer_oom_batch
    global _armed_infer_hang, _armed_sched_stall, _armed_sched_stall_ms
    global _armed_sched_stall_scope, _armed_warm_poison, _armed_warm_poison_fill
    global _armed_adapt_nan, _armed_adapt_regress
    if nan_step is not None:
        _armed_nan_step = nan_step
    if sigterm_step is not None:
        _armed_sigterm_step = sigterm_step
    if crash is not None:
        _armed_crash = crash
    if io_fail_reads is not None:
        _armed_io_fail_reads = set(io_fail_reads)
    if infer_decode_fail is not None:
        _armed_infer_decode_fail = set(infer_decode_fail)
    if infer_compile_fail is not None:
        _armed_infer_compile_fail = set(infer_compile_fail)
    if infer_oom_batch is not None:
        _armed_infer_oom_batch = int(infer_oom_batch)
    if infer_hang is not None:
        _armed_infer_hang = set(infer_hang)
    if sched_stall is not None:
        _armed_sched_stall = set(sched_stall)
    if sched_stall_ms is not None:
        _armed_sched_stall_ms = float(sched_stall_ms)
    if sched_stall_scope is not None:
        _armed_sched_stall_scope = str(sched_stall_scope)
    if warm_poison is not None:
        _armed_warm_poison = set(warm_poison)
    if warm_poison_fill is not None:
        _armed_warm_poison_fill = float(warm_poison_fill)
    if adapt_nan is not None:
        _armed_adapt_nan = set(adapt_nan)
    if adapt_regress is not None:
        _armed_adapt_regress = set(adapt_regress)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def poison_nan(step: int) -> bool:
    """True exactly when ``step`` is the armed NaN-injection step."""
    target = _armed_nan_step if _armed_nan_step is not None else _env_int("RAFT_FI_NAN_STEP")
    hit = target is not None and step == target
    if hit:
        logger.warning("[faultinject] poisoning batch at step %d with NaN", step)
    return hit


def maybe_sigterm(step: int) -> None:
    """Deliver SIGTERM to this process once, at the armed step."""
    global _sigterm_fired
    if _sigterm_fired:
        return
    target = (_armed_sigterm_step if _armed_sigterm_step is not None
              else _env_int("RAFT_FI_SIGTERM_STEP"))
    if target is not None and step == target:
        _sigterm_fired = True
        logger.warning("[faultinject] delivering SIGTERM at step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)


def crash_point(name: str) -> None:
    """Raise InjectedCrash if the named crash point is armed."""
    armed = _armed_crash or os.environ.get("RAFT_FI_CRASH", "").strip()
    if armed == name:
        raise InjectedCrash(f"[faultinject] injected crash at {name!r}")


# ------------------------------------------------------------------- IO


def _env_ordinals(name: str) -> Optional[Set[int]]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    return {int(x) for x in raw.split(",") if x.strip()}


def _next(counter: str) -> int:
    with _lock:
        globals()[counter] += 1
        return globals()[counter]


def io_read_attempts() -> int:
    """Read attempts of ``data/frame_io`` observed (for test assertions)."""
    return _io_read_attempts


def maybe_fail_io(path: str) -> None:
    """Count one read attempt; raise ``OSError`` if its ordinal is armed."""
    ordinal = _next("_io_read_attempts")
    armed = _armed_io_fail_reads
    if armed is None:
        armed = _env_ordinals("RAFT_FI_IO_FAIL_READS")
    if armed and ordinal in armed:
        raise OSError(f"[faultinject] injected IO failure on read attempt {ordinal}: {path}")


# -------------------------------------------------------------- serving


def infer_decode_attempts() -> int:
    """Engine decodes observed (for test assertions)."""
    return _infer_decode_attempts


def infer_compile_attempts() -> int:
    """Engine compiles (captures, or first eager runs) observed."""
    return _infer_compile_attempts


def infer_wait_attempts() -> int:
    """Engine device waits observed."""
    return _infer_wait_attempts


def infer_decode_point(payload=None) -> None:
    """Count one decode (the stager calls it once a request, before the
    request's inputs are resolved); raise ``OSError`` if its ordinal is
    armed."""
    ordinal = _next("_infer_decode_attempts")
    armed = _armed_infer_decode_fail
    if armed is None:
        armed = _env_ordinals("RAFT_FI_INFER_DECODE_FAIL")
    if armed and ordinal in armed:
        raise OSError(f"[faultinject] injected decode failure on request attempt {ordinal} "
                      f"(payload={payload!r})")


def infer_compile_point(key=None) -> None:
    """Count one compile of a new graph key; raise ``RuntimeError`` if its
    ordinal is armed."""
    ordinal = _next("_infer_compile_attempts")
    armed = _armed_infer_compile_fail
    if armed is None:
        armed = _env_ordinals("RAFT_FI_INFER_COMPILE_FAIL")
    if armed and ordinal in armed:
        raise RuntimeError(f"[faultinject] injected compile failure on attempt {ordinal} "
                           f"(key={key!r})")


def infer_wait_point(batch_size: int) -> None:
    """One device wait of a dispatched micro-batch, where real device errors
    and hangs surface: an armed hang ordinal parks this thread until
    ``reset()``; an armed OOM threshold raises ``torch.cuda.OutOfMemoryError``
    for every wait whose micro-batch is at least the threshold, so halving
    fits once the batch is below it."""
    ordinal = _next("_infer_wait_attempts")
    release = _hang_release
    hang = _armed_infer_hang
    if hang is None:
        hang = _env_ordinals("RAFT_FI_INFER_HANG")
    if hang and ordinal in hang:
        logger.warning("[faultinject] hanging device wait %d until reset()", ordinal)
        release.wait()
    oom = _armed_infer_oom_batch
    if oom is None:
        oom = _env_int("RAFT_FI_INFER_OOM")
    if oom is not None and batch_size >= oom:
        import torch

        raise torch.cuda.OutOfMemoryError(
            f"[faultinject] injected device OOM at micro-batch {batch_size} (threshold {oom})")


# ------------------------------------------------------ serving lifecycle


def sched_dispatch_attempts() -> int:
    """Scheduler dispatch-loop passes observed (for test assertions)."""
    with _lock:
        return _sched_dispatch_attempts


def _parse_sched_stall(raw: str):
    """``ORDINALS[:MS]`` -> (ordinal set, stall ms)."""
    spec, _, ms = raw.partition(":")
    ordinals = {int(x) for x in spec.split(",") if x.strip()}
    return ordinals, float(ms) if ms.strip() else 200.0


def sched_stall_point(label: Optional[str] = None) -> None:
    """Count one scheduler dispatch-loop pass (one a ``_next_group`` call,
    so ordinals are deterministic for a given stream); sleep first if its
    ordinal is armed, while admission keeps running. ``label`` names the
    calling scheduler (its tier): with a scope armed, only that scheduler
    stalls and its ordinals count its own passes."""
    global _sched_dispatch_attempts
    with _lock:
        _sched_dispatch_attempts += 1
        ordinal = _sched_dispatch_attempts
        scoped = None
        if label is not None:
            scoped = _sched_dispatch_by_label[label] = _sched_dispatch_by_label.get(label, 0) + 1
    armed, ms, scope = _armed_sched_stall, _armed_sched_stall_ms, _armed_sched_stall_scope
    if armed is None:
        raw = os.environ.get("RAFT_FI_SCHED_STALL", "").strip()
        if not raw:
            return
        armed, env_ms = _parse_sched_stall(raw)
        if ms is None:
            ms = env_ms
    if scope is None:
        scope = os.environ.get("RAFT_FI_SCHED_STALL_SCOPE", "").strip() or None
    if ms is None:
        ms = 200.0
    if scope is not None:
        if label != scope:
            return
        ordinal = scoped
    if armed and ordinal in armed:
        logger.warning("[faultinject] stalling scheduler dispatch pass %d for %.0f ms%s",
                       ordinal, ms, f" (scope={scope})" if scope else "")
        time.sleep(ms / 1e3)


def warm_reuse_attempts() -> int:
    """Warm-start reuses observed (for test assertions)."""
    return _warm_reuse_attempts


def warm_poison_point(slot):
    """Count one warm-start reuse (the session layer calls it once a frame
    that warm-starts from its predecessor); return the slot, or, if its
    ordinal is armed, a constant FILL field of the slot's shape and dtype."""
    ordinal = _next("_warm_reuse_attempts")
    armed, fill = _armed_warm_poison, _armed_warm_poison_fill
    if armed is None:
        raw = os.environ.get("RAFT_FI_WARM_POISON", "").strip()
        if not raw:
            return slot
        spec, _, fill_s = raw.partition(":")
        armed = {int(x) for x in spec.split(",") if x.strip()}
        if fill is None and fill_s.strip():
            fill = float(fill_s)
    if fill is None:
        fill = 40.0
    if armed and ordinal in armed:
        logger.warning("[faultinject] poisoning warm-start reuse %d with constant fill %.1f",
                       ordinal, fill)
        return slot * 0 + fill
    return slot


# ------------------------------------------------------------ adaptation


def adapt_attempts() -> int:
    """Adaptation-step attempts observed (for test assertions)."""
    return _adapt_attempts


def adapt_nan_point() -> bool:
    """Count one adaptation-step attempt (the adaptive server calls it once
    an attempted step, before the step runs); True if its ordinal is armed:
    the server then NaN-poisons the step's batch. Served requests are never
    touched."""
    ordinal = _next("_adapt_attempts")
    armed = _armed_adapt_nan
    if armed is None:
        armed = _env_ordinals("RAFT_FI_ADAPT_NAN")
    hit = bool(armed) and ordinal in armed
    if hit:
        logger.warning("[faultinject] NaN-poisoning adaptation step attempt %d", ordinal)
    return hit


def adapt_regress_checks() -> int:
    """Applied-step proxy observations (for test assertions)."""
    return _adapt_regress_checks


def adapt_regress_point(proxy: float) -> float:
    """Count one applied (finite) adaptation step's proxy observation;
    return it, inflated x10 if its ordinal is armed (a step that silently
    made serving worse, which the regression detector must catch)."""
    ordinal = _next("_adapt_regress_checks")
    armed = _armed_adapt_regress
    if armed is None:
        armed = _env_ordinals("RAFT_FI_ADAPT_REGRESS")
    if armed and ordinal in armed:
        logger.warning("[faultinject] inflating adaptation proxy loss x10 at applied step %d "
                       "(%.4f -> %.4f)", ordinal, proxy, proxy * 10.0)
        return float(proxy) * 10.0
    return float(proxy)
