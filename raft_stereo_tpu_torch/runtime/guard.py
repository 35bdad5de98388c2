"""Non-finite step guard (the port's own copy of
``raft_stereo_tpu/runtime/guard.py:33-136``): skip bad updates, abort on
streaks.

  * ``all_finite`` and the skip rule of ``apply_or_skip``: the train step
    applies the optimizer update only if the loss and every gradient are
    finite, so a bad step leaves parameters and optimizer moments bitwise
    untouched and costs one batch (``parallel/train_step.py`` reads the
    flag on the host once a step);
  * ``sanitize_metrics`` zeroes the non-finite metrics of a skipped step
    and records ``skipped``;
  * ``NonFiniteGuard`` counts the ``skipped`` flags on the host and raises
    ``NonFiniteStepError`` once ``max_consecutive`` steps in a row were
    skipped.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, List, Tuple

import torch

logger = logging.getLogger(__name__)


class NonFiniteStepError(RuntimeError):
    """Raised when too many consecutive train steps produced NaN/Inf."""


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Scalar bool tensor: every element of every tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t is not None]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def apply_or_skip(update, loss: torch.Tensor, grads: Iterable[torch.Tensor]) -> bool:
    """Run ``update()`` (the optimizer step) only if ``loss`` and every
    gradient are finite; returns whether it ran. The flag is read on the
    host: a skipped step writes nothing, moments included."""
    finite = bool(all_finite([loss, *grads]))
    if finite:
        update()
    return finite


def sanitize_metrics(metrics: dict, finite: bool) -> dict:
    """Zero non-finite metric values on *skipped* steps and record the flag
    as ``skipped`` (0. or 1.). On an applied step values pass through, so a
    metric-only NaN with finite loss and gradients still reaches the
    metric logger's fail-fast."""
    clean = {}
    for k, v in metrics.items():
        v = torch.as_tensor(v)
        clean[k] = v if finite else torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    clean["skipped"] = 0.0 if finite else 1.0
    return clean


class NonFiniteGuard:
    """Host-side streak counter over the per-step ``skipped`` flags."""

    def __init__(self, max_consecutive: int = 10, check_every: int = 25):
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        self.max_consecutive = max_consecutive
        self.check_every = max(int(check_every), 1)
        self.consecutive = 0
        self.total_skipped = 0
        self._pending: List[Tuple[int, Any]] = []

    def observe(self, step: int, skipped) -> None:
        """Record a step's skip flag; checked every ``check_every`` steps."""
        self._pending.append((step, skipped))
        if len(self._pending) >= self.check_every:
            self.check()

    def check(self) -> None:
        """Read the pending flags and enforce the streak threshold."""
        pending, self._pending = self._pending, []
        for step, flag in pending:
            if float(flag) > 0:
                self.consecutive += 1
                self.total_skipped += 1
                logger.warning("non-finite train step %d skipped (%d consecutive, %d total)",
                               step, self.consecutive, self.total_skipped)
                if self.consecutive >= self.max_consecutive:
                    raise NonFiniteStepError(
                        f"aborting: {self.consecutive} consecutive train steps produced "
                        f"non-finite loss/grads (last at step {step}; threshold "
                        f"--max_skipped_steps={self.max_consecutive}). The parameter state "
                        "is still finite: resume from the last checkpoint with a lower LR "
                        "or inspect the data.")
            else:
                self.consecutive = 0
