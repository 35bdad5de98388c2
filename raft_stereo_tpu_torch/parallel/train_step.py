"""The training step: optimizer, schedule and update (the port's own copy
of ``raft_stereo_tpu/parallel/train_step.py:34-140``), on one card or, with
``ddp``, one rank of a data-parallel group.

  * AdamW + a linear OneCycle schedule (pct_start 0.01 over num_steps + 100,
    reference train_stereo.py:74-75), gradients clipped by global norm 1.0
    (reference :175).
  * Where PyTorch's stock pieces differ from optax, the port follows optax:
    the clip scales by max_norm/‖g‖ exactly when ‖g‖ >= max_norm
    (``clip_grad_norm_`` adds 1e-6 to the norm); the schedule is optax's
    two joined linear ramps written as a function and driven through
    ``LambdaLR`` on a base lr of 1.0, so the k-th update uses
    ``schedule(k-1)`` exactly; AdamW decays every parameter, as optax's
    ``adamw`` does (a parameter the loss does not reach gets a zero
    gradient, not a skipped update).
  * Mixed precision is the model's bf16 compute on fp32 parameters with no
    loss scaling, as in the JAX package (no fp16 autocast, no GradScaler).
  * ``ddp``: the JAX mesh step's data axis. The forward runs through a
    ``DistributedDataParallel`` wrapper of the model, which averages the
    gradients over the ranks during the backward; ``sequence_loss`` takes
    its masked means over the global batch, so the average is the global
    loss's gradient, and the clip, the guard and AdamW then run on the
    synced gradients, as optax runs after XLA's all-reduce. The train
    state keeps the inner module, so a checkpoint's keys carry no
    ``module.`` prefix and move between world sizes. Batch-norm statistics
    are frozen (``FrozenBatchNorm``), so buffers are not broadcast and no
    ``SyncBatchNorm`` is needed; every parameter of RAFT-Stereo is reached
    by the loss, so DDP does not look for unused ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from raft_stereo_tpu_torch import losses
from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.runtime.guard import apply_or_skip, sanitize_metrics


def onecycle_linear(peak_lr: float, total_steps: int,
                    pct_start: float = 0.01) -> Callable[[int], float]:
    """Linear warmup from peak/25 to peak over max(int(total·pct), 1)
    updates, then linear decay to peak/1e4: optax's
    ``join_schedules([linear_schedule(peak/25, peak, w),
    linear_schedule(peak, peak/1e4, total - w)], [w])`` in float64."""
    warmup = max(int(total_steps * pct_start), 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        if steps <= 0:
            return init
        count = min(max(count, 0), steps)
        frac = 1 - count / steps
        return (init - end) * frac + end

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(peak_lr / 25.0, peak_lr, warmup, count)
        return linear(peak_lr, peak_lr / 1e4, total_steps - warmup, count - warmup)

    return schedule


def make_optimizer(params, cfg: TrainConfig
                   ) -> Tuple[torch.optim.AdamW, LambdaLR, Callable[[int], float]]:
    """AdamW (eps 1e-8, weight decay ``cfg.wdecay``) on a base lr of 1.0,
    ``LambdaLR`` driving it with the schedule, and the schedule."""
    schedule = onecycle_linear(cfg.lr, cfg.num_steps + 100)
    optimizer = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=cfg.wdecay)
    return optimizer, LambdaLR(optimizer, schedule), schedule


@dataclasses.dataclass
class TrainState:
    """The model with its optimizer, schedule and update count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, tree: dict) -> None:
        self.model.load_state_dict(tree["model"], strict=True)
        self.optimizer.load_state_dict(tree["optimizer"])
        self.scheduler.load_state_dict(tree["scheduler"])
        self.step = int(tree["step"])

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    optimizer, scheduler, _ = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], cfg)
    return TrainState(model, optimizer, scheduler)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: every gradient scaled by
    max_norm/‖g‖ where ‖g‖ >= max_norm (no host sync). Returns ‖g‖."""
    norm = torch.sqrt(torch.stack([torch.sum(g.float() ** 2) for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def apply_update(state: TrainState, loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
                 grad_clip: float = 1.0, nonfinite_guard: bool = False,
                 distributed: bool = False):
    """The update after ``loss.backward()``: every trainable parameter's
    gradient (zero where the loss does not reach it) clipped by global
    norm, the AdamW step and the schedule's step, and ``state.step += 1``.
    With ``nonfinite_guard`` a non-finite loss or gradient skips the update
    (parameters, moments and schedule bitwise unchanged; the step counter
    still advances; ``distributed``: on every rank together) and the
    metrics carry ``skipped``. ``live_loss`` is ``loss`` unless the metrics
    already carry it (the global loss of a distributed step)."""
    optimizer = state.optimizer
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    metrics = {k: v.detach()
               for k, v in dict(metrics, live_loss=metrics.get("live_loss", loss)).items()}

    def update():
        clip_by_global_norm_(grads, grad_clip)
        optimizer.step()
        state.scheduler.step()

    if nonfinite_guard:
        metrics = sanitize_metrics(metrics, apply_or_skip(update, loss, grads, distributed))
    else:
        update()
    state.step += 1
    return state, metrics


def make_train_step(train_iters: int, loss_gamma: float = 0.9, max_flow: float = 700.0,
                    remat: bool = True, nonfinite_guard: bool = False,
                    grad_clip: float = 1.0, ddp: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: the train-mode
    forward, ``sequence_loss``, the backward and :func:`apply_update`.

    ``batch``: img1/img2 [B, H, W, 3], flow [B, H, W, 1], valid [B, H, W]
    on the model's device (with ``ddp``, this rank's piece of the global
    batch). ``remat`` recomputes each refinement iteration in the backward.
    ``ddp``: the step of one rank of the process group; the first call
    with a model wraps it in ``DistributedDataParallel`` on its device
    (which broadcasts rank 0's parameters once, so a restore or warm start
    comes before it), and ``state`` keeps the model unwrapped."""
    wrapped: List[Tuple[nn.Module, nn.Module]] = []  # (model, its wrapper)

    def forward_module(model: nn.Module) -> nn.Module:
        if not ddp:
            return model
        if not wrapped or wrapped[0][0] is not model:
            from torch.nn.parallel import DistributedDataParallel

            dev = next(model.parameters()).device
            wrapped[:] = [(model, DistributedDataParallel(
                model, device_ids=[dev] if dev.type == "cuda" else None,
                broadcast_buffers=False, find_unused_parameters=False))]
        return wrapped[0][1]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad(set_to_none=True)
        preds = forward_module(state.model)(batch["img1"], batch["img2"], iters=train_iters,
                                            test_mode=False, remat=remat)
        loss, metrics = losses.sequence_loss(preds, batch["flow"], batch["valid"], loss_gamma,
                                             max_flow, distributed=ddp)
        loss.backward()
        return apply_update(state, loss, metrics, grad_clip, nonfinite_guard, distributed=ddp)

    return train_step
