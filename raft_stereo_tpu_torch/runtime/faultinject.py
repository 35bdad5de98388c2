"""Deterministic fault injection for the training runtime (the port's own
copy of the training points of ``raft_stereo_tpu/runtime/faultinject.py``).

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
                            its rename)
"""

from __future__ import annotations

import logging
import os
import signal
from typing import Optional

logger = logging.getLogger(__name__)


class InjectedCrash(RuntimeError):
    """Raised by an armed ``crash_point``."""


_armed_nan_step: Optional[int] = None
_armed_sigterm_step: Optional[int] = None
_armed_crash: Optional[str] = None
_sigterm_fired = False


def reset() -> None:
    """Clear programmatic arming and the once-only SIGTERM latch (the
    environment is left alone)."""
    global _armed_nan_step, _armed_sigterm_step, _armed_crash, _sigterm_fired
    _armed_nan_step = _armed_sigterm_step = _armed_crash = None
    _sigterm_fired = False


def arm(nan_step: Optional[int] = None, sigterm_step: Optional[int] = None,
        crash: Optional[str] = None) -> None:
    """Programmatic arming for in-process tests (overrides env vars)."""
    global _armed_nan_step, _armed_sigterm_step, _armed_crash
    if nan_step is not None:
        _armed_nan_step = nan_step
    if sigterm_step is not None:
        _armed_sigterm_step = sigterm_step
    if crash is not None:
        _armed_crash = crash


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
