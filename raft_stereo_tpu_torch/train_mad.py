"""MADNet2 training and online Modular ADaptation on one CUDA card (PyTorch
port of ``raft_stereo_tpu/train_mad.py``; the reference's train_mad.py,
train_mad2.py and train_mad_fusion.py in one trainer).

    python -m raft_stereo_tpu_torch.train_mad [--variant mad|mad2|fusion]
    python -m raft_stereo_tpu_torch.train_mad --adapt mad --restore_ckpt CKPT

  * ``--variant mad``: supervised MADNet2 on dense GT (Adam + StepLR(150000,
    0.5), reference train_mad.py:130-141);
  * ``--variant mad2``: the weighted-level loss [0.08, 0.02, 0.01, 0.005,
    0.32] with error-rate metrics and StepLR(419700) (train_mad2.py);
  * ``--variant fusion``: MADNet2Fusion with the GT disparity as its
    guidance proxy (train_mad_fusion.py:238-243);
  * ``--adapt MODE``: online self-supervised adaptation (full / full++ / mad
    / mad++) over the dataset's frames in order, the host-side
    ``MADController`` choosing the block (``runtime.adapt.make_adapt_step``).

A batch is padded to ÷128, every level is nearest-upsampled ×2^(i+2) and
scaled ×−20, unpadded, and the loss taken at full resolution.

The optimizer is optax's chain, not torch's defaults: the global-norm clip
at 1.0 (scaling by 1/norm only at or above 1), the decayed weights added to
the gradient (torch Adam's coupled weight decay), Adam at eps 1e-8 on a
staircase schedule counted in updates. optax updates every parameter every
step, a block the MAD step did not sample moving on its earlier moments, so
every parameter gets a zero gradient where autograd leaves none
(``parallel.train_step.apply_update``).

Training runs on the port's loop (``runtime/loop.py``: a stager, periodic
and final checkpoints with manifests, ``--resume auto``, SIGTERM, the
non-finite guard, telemetry). Everything runs on the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from raft_stereo_tpu_torch.data.datasets import build_train_dataset, fetch_dataloader
from raft_stereo_tpu_torch.evaluate import resolve_device
from raft_stereo_tpu_torch.evaluate_mad import load_mad_weights
from raft_stereo_tpu_torch.models.madnet2 import (
    DIVIS_BY,
    MADController,
    compute_mad_loss,
    make_madnet2,
)
from raft_stereo_tpu_torch.ops.pad import InputPadder
from raft_stereo_tpu_torch.parallel.train_step import TrainState, apply_update
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.adapt import make_adapt_step as _make_rich_adapt_step
from raft_stereo_tpu_torch.runtime.adapt import upsample_predictions
from raft_stereo_tpu_torch.runtime.guard import NonFiniteGuard
from raft_stereo_tpu_torch.runtime.loop import (
    LoopResult,
    add_loop_args,
    cpu_stage_fn,
    cuda_stage_fn,
    resume_state,
    run_training_loop,
    unstage,
)
from raft_stereo_tpu_torch.utils.checkpoints import save_train_state
from raft_stereo_tpu_torch.utils.metrics import MetricLogger

logger = logging.getLogger(__name__)


def mad2_loss(disp_preds, disp_gt, valid, max_disp: float = 192.0):
    """The weighted per-level loss and percentage metrics of train_mad2.py:37-73."""
    if valid.ndim == 3:
        valid = valid[..., None]
    mag = torch.sqrt(torch.sum(disp_gt ** 2, dim=-1, keepdim=True))
    v = (valid >= 0.5) & (mag < max_disp)
    weights = torch.tensor([0.08, 0.02, 0.01, 0.005, 0.32], device=disp_gt.device)
    losses = torch.stack([0.001 * torch.where(v, (p - disp_gt).abs(), 0.0).sum() / 20.0
                          for p in disp_preds])
    loss = (losses * weights).mean()
    epe = torch.sqrt(torch.sum((disp_preds[0] - disp_gt) ** 2, dim=-1))
    vv = v[..., 0]
    denom = vv.sum().clamp_min(1)

    def mean(x):
        return torch.where(vv, x, 0.0).sum() / denom

    metrics = {
        "epe": mean(epe),
        "1px": mean((epe > 1).float()) * 100,
        "3px": mean((epe > 3).float()) * 100,
        "5px": mean((epe > 5).float()) * 100,
    }
    return loss, metrics


def make_mad_train_step(variant: str, fusion: bool, nonfinite_guard: bool = False):
    """``step(state, batch) -> (state, metrics)``: pad to ÷128, forward,
    upsample, the variant's loss, backward and the update. ``batch``: img1,
    img2 [B, H, W, 3], flow [B, H, W, 1], valid [B, H, W] (and guide
    [B, H, W, 1] for the Fusion variant) on the model's device."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad(set_to_none=True)
        padder = InputPadder(batch["img1"].shape, divis_by=DIVIS_BY)
        img1, img2 = padder.pad(batch["img1"], batch["img2"])
        if fusion:
            (guide,) = padder.pad(batch["guide"])
            preds = state.model(img1, img2, guide)
        else:
            preds = state.model(img1, img2)
        full = upsample_predictions(preds, padder)
        if variant == "mad2":
            loss, metrics = mad2_loss(full, batch["flow"], batch["valid"])
        else:
            loss, metrics = compute_mad_loss(batch["img1"], batch["img2"], full, batch["flow"],
                                             batch["valid"])
        loss.backward()
        return apply_update(state, loss, metrics, nonfinite_guard=nonfinite_guard)

    return step


def make_adapt_step(adapt_mode: str):
    """The offline adaptation step, ``step(state, batch, idx) -> (state,
    loss)`` (``runtime.adapt.make_adapt_step`` without the guard)."""
    rich = _make_rich_adapt_step(adapt_mode)

    def step(state, batch, idx: int):
        state, info = rich(state, batch, idx)
        return state, info["loss"]

    return step


def adapt_online(state: TrainState, batches, adapt_mode: str = "mad", seed: int = 0):
    """Online MAD adaptation over a stream of stereo batches (numpy): sample
    a block from the reward distribution, adapt on that block's loss, credit
    the expected-loss gain (reference madnet2.py:36-76,146-179). Returns
    (state, controller, losses)."""
    controller = MADController(seed=seed)
    step = make_adapt_step(adapt_mode)
    single = adapt_mode in ("mad", "mad++")
    dev = next(state.model.parameters()).device
    losses = []
    for batch in batches:
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        idx = controller.sample_block() if single else controller.sample_all()
        state, loss = step(state, batch, int(idx))
        loss = float(loss)
        losses.append(loss)
        if single:
            controller.update_sample_distribution(int(idx), loss)
    return state, controller, losses


def staircase(lr: float, step_size: int, rate: float = 0.5) -> Callable[[int], float]:
    """optax's ``exponential_decay(lr, step_size, rate, staircase=True)``."""

    def schedule(count: int) -> float:
        return lr * rate ** (count // step_size)

    return schedule


def fetch_mad_optimizer(args, params) -> Tuple[torch.optim.Adam, LambdaLR, Callable]:
    """Adam + StepLR (reference train_mad.py:130-141, train_mad2.py:114-116)
    as optax chains them: decayed weights added before Adam (torch Adam's
    coupled weight decay, the reference's ``optim.Adam``), eps 1e-8, the
    staircase schedule driven through ``LambdaLR`` on a base lr of 1.0, so
    the k-th update uses ``schedule(k-1)``. The global-norm clip at 1.0 is
    ``apply_update``'s."""
    schedule = staircase(args.lr, 419_700 if args.variant == "mad2" else 150_000)
    optimizer = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=args.wdecay)
    return optimizer, LambdaLR(optimizer, schedule), schedule


def _init_model_state(args, fusion: bool = False, device=None):
    """The model (seed 1234) and its train state, ``--restore_ckpt`` applied
    (a reference ``.pth`` or a port checkpoint's weights); ``(state,
    schedule)``."""
    model = make_madnet2(mixed_precision=args.mixed_precision and not fusion, fusion=fusion,
                         seed=1234)
    if args.restore_ckpt:
        load_mad_weights(model, args.restore_ckpt)
    model = model.to(resolve_device(device)).train()
    logger.info("Parameter Count: %d", sum(p.numel() for p in model.parameters()))
    optimizer, scheduler, schedule = fetch_mad_optimizer(args, list(model.parameters()))
    return TrainState(model, optimizer, scheduler), schedule


def sequential_stream(dataset, batch_size: int, num_steps: int):
    """In-order, augmentation-free batches, as frames arrive from a video
    (the reference adapts KITTI raw sequences in order); wraps around."""
    if len(dataset) == 0:
        raise ValueError("sequential_stream: dataset is empty: check --train_datasets and "
                         "the dataset root paths")
    idx = 0
    for _ in range(num_steps):
        items = [dataset[(idx + j) % len(dataset)] for j in range(batch_size)]
        idx = (idx + batch_size) % len(dataset)
        yield {
            "img1": np.stack([x[0] for x in items]),
            "img2": np.stack([x[1] for x in items]),
            "flow": np.stack([x[2] for x in items]),
            "valid": np.stack([x[3] for x in items]),
        }


def adapt(args, device=None) -> Path:
    """``--adapt MODE``: adapt the restored model over the dataset's frames
    in order, full size and unaugmented; saves
    ``checkpoints/NAME/NAME_adapted``. Frames vary in size across
    sequences, so keep ``--batch_size 1``."""
    global _last_adapt
    state, _ = _init_model_state(args, device=device)
    dataset = build_train_dataset(args, aug_params=None)
    stream = sequential_stream(dataset, args.batch_size, args.num_steps)
    state, controller, losses = adapt_online(state, stream, adapt_mode=args.adapt,
                                             seed=args.seed)
    logger.info("adapted %d steps (%s): loss %.4f -> %.4f  distribution=%s", len(losses),
                args.adapt, losses[0], losses[-1],
                np.round(controller.sample_distribution, 4).tolist())
    ckpt_dir = Path("checkpoints") / args.name
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"{args.name}_adapted"
    save_train_state(str(path), state)
    _last_adapt = {"losses": losses, "distribution": controller.sample_distribution.tolist(),
                   "path": str(path)}
    return path


# The last ``adapt`` run's losses, block distribution and checkpoint path.
_last_adapt: Optional[dict] = None


def last_adapt() -> Optional[dict]:
    return _last_adapt


def train(args, device=None) -> LoopResult:
    fusion = args.variant == "fusion"
    dev = resolve_device(device)
    ckpt_dir = Path("checkpoints") / args.name
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    run_dir = f"runs/{args.name}"
    # installed before the resume, so restore decisions reach events.jsonl
    tel = telemetry.install(telemetry.Telemetry(run_dir)) if args.telemetry else None
    try:
        return _train_under_telemetry(args, dev, fusion, ckpt_dir, run_dir)
    finally:
        telemetry.uninstall(tel)


def _train_under_telemetry(args, dev, fusion, ckpt_dir, run_dir) -> LoopResult:
    # a resume wins over a warm start: the resumed checkpoint already holds
    # the warm-started and trained state
    restore_ckpt = args.restore_ckpt
    resumed, rm, stream_pos = False, None, 0
    state, schedule = _init_model_state(
        argparse.Namespace(**{**vars(args), "restore_ckpt": None}), fusion, dev)
    if args.resume:
        state, rm, resume_path = resume_state(args.resume, ckpt_dir, state)
        if resume_path:
            resumed = True
            stream_pos = int((rm or {}).get("stream_pos", state.step))
            logger.info("Resumed from %s at step %d (stream position %d)", resume_path,
                        state.step, stream_pos)
            telemetry.emit("resume", step=int(state.step), path=resume_path,
                           stream_pos=stream_pos)
    if not resumed and restore_ckpt:
        load_mad_weights(state.model, restore_ckpt)

    nan_guard = not args.no_nan_guard
    step = make_mad_train_step(args.variant, fusion, nonfinite_guard=nan_guard)
    guard = NonFiniteGuard(max_consecutive=args.max_skipped_steps) if nan_guard else None
    loader = fetch_dataloader(args)
    mlog = MetricLogger(run_dir=run_dir, schedule=schedule)
    stream_geometry = {"batch_size": int(args.batch_size), "num_shards": 1,
                       "dataset_len": len(loader.dataset)}

    def step_fn(s, staged):
        batch = unstage(staged)
        if fusion:  # the GT disparity as the guidance proxy
            batch = dict(batch, guide=batch["flow"])
        return step(s, batch)

    try:
        return run_training_loop(
            state=state, step_fn=step_fn, loader=loader,
            stage_fn=cuda_stage_fn(dev) if dev.type == "cuda" else cpu_stage_fn,
            ckpt_dir=ckpt_dir, name=args.name, num_steps=args.num_steps,
            validation_frequency=args.validation_frequency, keep_ckpts=args.keep_ckpts,
            mlog=mlog, guard=guard, resumed=resumed, resume_manifest=rm,
            stream_pos=stream_pos, stream_geometry=stream_geometry,
            prefetch_depth=args.prefetch_depth, async_ckpt=args.async_ckpt, run_dir=run_dir,
            profile_steps=args.profile_steps, profile_dir=os.path.join(run_dir, "profile"),
        )
    finally:
        mlog.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", default="madnet2")
    parser.add_argument("--variant", default="mad", choices=["mad", "mad2", "fusion"])
    parser.add_argument("--adapt", default=None, choices=["full", "full++", "mad", "mad++"],
                        help="online adaptation mode (reference madnet2.py:146-179); "
                        "overrides --variant")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--restore_ckpt", default=None,
                        help="warm start: a reference .pth or a port checkpoint")
    parser.add_argument("--resume", default=None, metavar="auto|PATH",
                        help="resume from a committed checkpoint ('auto': the newest valid "
                        "one under checkpoints/NAME)")
    parser.add_argument("--keep_ckpts", type=int, default=3,
                        help="rotation: keep this many periodic checkpoints")
    add_loop_args(parser)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="default 6 for training, 1 for --adapt (streamed frames vary in "
                        "size across sequences)")
    parser.add_argument("--train_datasets", nargs="+", default=["sceneflow"])
    parser.add_argument("--lr", type=float, default=0.0001)
    parser.add_argument("--num_steps", type=int, default=600000)
    parser.add_argument("--image_size", type=int, nargs="+", default=[384, 768])
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--wdecay", type=float, default=1e-5)
    parser.add_argument("--validation_frequency", type=int, default=10000)
    parser.add_argument("--img_gamma", type=float, nargs="+", default=None)
    parser.add_argument("--saturation_range", type=float, nargs="+", default=None)
    parser.add_argument("--do_flip", default=None, choices=["h", "v"])
    parser.add_argument("--spatial_scale", type=float, nargs="+", default=[0, 0])
    parser.add_argument("--noyjitter", action="store_true")
    return parser


def main(argv=None, device: Optional[str] = None):
    """Train (the loop's ``LoopResult``) or, with ``--adapt``, adapt (the
    adapted checkpoint's path)."""
    args = build_parser().parse_args(argv)
    if args.batch_size is None:
        args.batch_size = 1 if args.adapt else 6
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    Path("checkpoints").mkdir(exist_ok=True)
    return adapt(args, device) if args.adapt else train(args, device)


if __name__ == "__main__":
    main()
