"""Training entry point on one CUDA card (the port of
``raft_stereo_tpu/train.py``, the reference's train_stereo.py).

    python -m raft_stereo_tpu_torch.train --batch_size 8 --train_iters 22 \\
        --mixed_precision --spatial_scale -0.2 0.4 --saturation_range 0 1.4

The flag surface is the JAX package's (reference train_stereo.py:214-249)
without its multi-host and telemetry flags. Checkpoints carry the model,
the optimizer's moments, the schedule, the step and the data-stream
position, so ``--resume auto`` continues exactly where a run stopped; the
loop (``runtime/loop.py``) stages batches ahead of the step and commits
periodic checkpoints on a background thread.

Everything runs on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request it raises.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.config import (
    CORR_IMPLEMENTATIONS,
    PRESET_FLAGS,
    RAFTStereoConfig,
    TrainConfig,
    apply_preset_defaults,
)
from raft_stereo_tpu_torch.data.datasets import fetch_dataloader
from raft_stereo_tpu_torch.evaluate import resolve_device, validate_things
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    onecycle_linear,
)
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
from raft_stereo_tpu_torch.utils.checkpoints import restore_train_state
from raft_stereo_tpu_torch.utils.metrics import MetricLogger

logger = logging.getLogger(__name__)


def train(args, device=None) -> LoopResult:
    dev = resolve_device(device)
    Path("checkpoints").mkdir(exist_ok=True)
    cfg = RAFTStereoConfig(
        hidden_dims=tuple(args.hidden_dims),
        corr_implementation=args.corr_implementation,
        shared_backbone=args.shared_backbone,
        corr_levels=args.corr_levels,
        corr_radius=args.corr_radius,
        n_downsample=args.n_downsample,
        context_norm=args.context_norm,
        slow_fast_gru=args.slow_fast_gru,
        n_gru_layers=args.n_gru_layers,
        mixed_precision=args.mixed_precision,
    )
    tcfg = TrainConfig(
        name=args.name, batch_size=args.batch_size, train_datasets=tuple(args.train_datasets),
        lr=args.lr, num_steps=args.num_steps, image_size=tuple(args.image_size),
        train_iters=args.train_iters, valid_iters=args.valid_iters, wdecay=args.wdecay,
        seed=1234,
    )
    model = RAFTStereo(cfg)
    init_weights(model, torch.Generator().manual_seed(tcfg.seed))
    model = model.to(dev).train()
    logger.info("Parameter Count: %d", sum(p.numel() for p in model.parameters()))
    state = create_train_state(model, tcfg)

    ckpt_dir = Path("checkpoints") / args.name
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    run_dir = f"runs/{args.name}"

    # A resume wins over a warm start: the resumed checkpoint already holds
    # the warm-started and trained state.
    resumed = False
    rm = None  # manifest of the checkpoint resumed from
    stream_pos = 0  # batches consumed from this loader lineage (not state.step)
    if args.resume:
        state, rm, resume_path = resume_state(args.resume, ckpt_dir, state)
        if resume_path:
            resumed = True
            stream_pos = int((rm or {}).get("stream_pos", state.step))
            logger.info("Resumed from %s at step %d (stream position %d)", resume_path,
                        state.step, stream_pos)
    if not resumed and args.restore_ckpt:
        state = restore_train_state(args.restore_ckpt, state)
        logger.info("Restored checkpoint %s at step %d", args.restore_ckpt, state.step)

    nan_guard = not args.no_nan_guard
    step = make_train_step(tcfg.train_iters, tcfg.loss_gamma, tcfg.max_flow, remat=tcfg.remat,
                           nonfinite_guard=nan_guard, grad_clip=tcfg.grad_clip)
    guard = NonFiniteGuard(max_consecutive=args.max_skipped_steps) if nan_guard else None
    loader = fetch_dataloader(args)
    mlog = MetricLogger(run_dir=run_dir, schedule=onecycle_linear(tcfg.lr, tcfg.num_steps + 100))
    stream_geometry = {"batch_size": int(args.batch_size), "num_shards": 1,
                       "dataset_len": len(loader.dataset)}

    def validate_fn(step_num, cur_state):
        cur_state.model.eval()
        try:
            results = validate_things(cur_state.model, iters=tcfg.valid_iters)
        finally:
            cur_state.model.train()
        mlog.write_dict(step_num, results)

    try:
        return run_training_loop(
            state=state,
            step_fn=lambda s, staged: step(s, unstage(staged)),
            loader=loader,
            stage_fn=cuda_stage_fn(dev) if dev.type == "cuda" else cpu_stage_fn,
            ckpt_dir=ckpt_dir,
            name=args.name,
            num_steps=tcfg.num_steps,
            validation_frequency=args.validation_frequency,
            keep_ckpts=args.keep_ckpts,
            mlog=mlog,
            guard=guard,
            resumed=resumed,
            resume_manifest=rm,
            stream_pos=stream_pos,
            stream_geometry=stream_geometry,
            prefetch_depth=args.prefetch_depth,
            async_ckpt=args.async_ckpt,
            validate_fn=validate_fn if args.validate else None,
            run_dir=run_dir,
        )
    finally:
        mlog.close()


def build_parser(argv=None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", default="raft-stereo", help="name your experiment")
    parser.add_argument("--restore_ckpt", default=None,
                        help="warm start: a port checkpoint, or a reference .pth")
    parser.add_argument(
        "--resume", default=None, metavar="auto|PATH",
        help="resume exactly from a committed checkpoint: 'auto' restores the newest valid "
        "checkpoint under checkpoints/NAME (skipping corrupt ones), a path restores that one")
    parser.add_argument("--keep_ckpts", type=int, default=3,
                        help="rotation: keep this many periodic checkpoints (final and "
                        "emergency checkpoints are not rotated away)")
    add_loop_args(parser)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--validate", action="store_true",
                        help="run validate_things at checkpoints")

    # Training parameters (reference train_stereo.py:219-229)
    parser.add_argument("--batch_size", type=int, default=6)
    parser.add_argument("--train_datasets", nargs="+", default=["sceneflow"])
    parser.add_argument("--lr", type=float, default=0.0002)
    parser.add_argument("--num_steps", type=int, default=100000)
    parser.add_argument("--image_size", type=int, nargs="+", default=[320, 720])
    parser.add_argument("--train_iters", type=int, default=16)
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--wdecay", type=float, default=1e-5)
    parser.add_argument("--validation_frequency", type=int, default=10000)

    # Architecture choices (reference train_stereo.py:231-240)
    parser.add_argument("--hidden_dims", nargs="+", type=int, default=[128] * 3)
    parser.add_argument("--corr_implementation", choices=list(CORR_IMPLEMENTATIONS),
                        default="reg")
    parser.add_argument("--shared_backbone", action="store_true")
    parser.add_argument("--corr_levels", type=int, default=4)
    parser.add_argument("--corr_radius", type=int, default=4)
    parser.add_argument("--n_downsample", type=int, default=2)
    parser.add_argument("--context_norm", default="batch",
                        choices=["group", "batch", "instance", "none"])
    parser.add_argument("--slow_fast_gru", action="store_true")
    parser.add_argument("--n_gru_layers", type=int, default=3)

    # Data augmentation (reference train_stereo.py:243-249)
    parser.add_argument("--img_gamma", type=float, nargs="+", default=None)
    parser.add_argument("--saturation_range", type=float, nargs="+", default=None)
    parser.add_argument("--do_flip", default=None, choices=["h", "v"])
    parser.add_argument("--spatial_scale", type=float, nargs="+", default=[0, 0])
    parser.add_argument("--noyjitter", action="store_true")

    parser.add_argument("--preset", choices=list(PRESET_FLAGS), default=None,
                        help="named model preset; explicit flags override")
    apply_preset_defaults(parser, argv)
    return parser


def main(argv=None, device: Optional[str] = None) -> LoopResult:
    """Parse ``argv`` and train; returns the loop's result (``.path`` is the
    final checkpoint, or the emergency one after a preemption)."""
    args = build_parser(argv).parse_args(argv)
    np.random.seed(1234)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    return train(args, device=device)


if __name__ == "__main__":
    main()
