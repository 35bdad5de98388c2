"""Architecture and training configuration of the RAFT-Stereo model family
(PyTorch port).

The port's own copy of ``raft_stereo_tpu/config.py:16-204``: the same flag
vocabulary, defaults, validation and named presets, so a command line of the
JAX package builds the same architecture here, and the same augmentation
and training hyper-parameters (one card: no data-parallel fields).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional, Tuple

# Backend selector values; ``reg_cuda``/``alt_cuda`` are the reference-era
# spellings of the kernel backends.
CORR_IMPLEMENTATIONS = ("reg", "alt", "reg_pallas", "alt_pallas", "reg_cuda", "alt_cuda")

_CORR_ALIASES = {"reg_cuda": "reg_pallas", "alt_cuda": "alt_pallas"}


def canonical_corr_implementation(name: str) -> str:
    """Map reference-era names onto the canonical backend names."""
    if name not in CORR_IMPLEMENTATIONS:
        raise ValueError(
            f"unknown corr_implementation {name!r}; expected one of {CORR_IMPLEMENTATIONS}"
        )
    return _CORR_ALIASES.get(name, name)


@dataclasses.dataclass(frozen=True)
class RAFTStereoConfig:
    """Architecture config; defaults are the reference defaults."""

    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    corr_implementation: str = "reg"
    shared_backbone: bool = False
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    context_norm: str = "batch"  # group | batch | instance | none
    slow_fast_gru: bool = False
    n_gru_layers: int = 3
    mixed_precision: bool = False  # bf16 compute for the convs
    # Each test-mode refinement step but the last (masked) one runs as one
    # fused step (ops/fused_update.py): the lookup, the motion encoder, the
    # finest ConvGRU and the flow head. On CUDA the kernel runs or the call
    # raises. The correlation state is then always ``alt``.
    fused_update: bool = False
    # Batch-level convergence exit of the refinement loop: when > 0, the
    # loop stops once the largest per-sample mean |delta| of a step falls
    # below this (ops.fused_update.batch_max_delta), and the forward
    # returns a third element, the number of iterations run. 0 disables it.
    converge_eps: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if self.n_gru_layers not in (1, 2, 3):
            raise ValueError(f"n_gru_layers must be 1..3, got {self.n_gru_layers}")
        if len(self.hidden_dims) != 3:
            raise ValueError("hidden_dims must have exactly 3 entries")
        if len(set(self.hidden_dims)) != 1:
            # the cross-scale GRU wiring assumes uniform widths
            raise ValueError("hidden_dims entries must be uniform")
        if self.context_norm not in ("group", "batch", "instance", "none"):
            raise ValueError(f"bad context_norm {self.context_norm!r}")
        if not math.isfinite(self.converge_eps) or self.converge_eps < 0.0:
            # NaN would make the exit test (dnorm >= eps) always False:
            # every batch would silently run one refinement step
            raise ValueError(
                f"converge_eps must be finite and >= 0 (0 disables the "
                f"early exit), got {self.converge_eps}"
            )
        canonical_corr_implementation(self.corr_implementation)

    @property
    def corr_backend(self) -> str:
        return canonical_corr_implementation(self.corr_implementation)

    @property
    def downsample_factor(self) -> int:
        return 2 ** self.n_downsample


# Named presets: each maps to the CLI flags of the reference command line,
# including the iteration count.
PRESET_FLAGS = {
    "raftstereo": {},
    "raftstereo-realtime": dict(
        shared_backbone=True,
        n_downsample=3,
        n_gru_layers=2,
        slow_fast_gru=True,
        corr_implementation="alt",
        mixed_precision=True,
        valid_iters=7,
    ),
    "raftstereo-middlebury": dict(corr_implementation="alt", mixed_precision=True),
    "iraftstereo-rvc": dict(context_norm="instance"),
}

_MODEL_FIELDS = {f.name for f in dataclasses.fields(RAFTStereoConfig)}

PRESETS = {
    name: RAFTStereoConfig(**{k: v for k, v in flags.items() if k in _MODEL_FIELDS})
    for name, flags in PRESET_FLAGS.items()
}


def apply_preset_defaults(parser: argparse.ArgumentParser, argv):
    """Two-phase CLI parse: a preset rewrites the parser's defaults to its
    flags, so explicitly passed flags still override."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", choices=list(PRESET_FLAGS), default=None)
    ns, _ = pre.parse_known_args(argv)
    if ns.preset:
        parser.set_defaults(**PRESET_FLAGS[ns.preset])
    return parser


def config_from_args(args) -> RAFTStereoConfig:
    return RAFTStereoConfig(
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
        fused_update=args.fused_update,
        # the convergence exit is part of the model (the refinement loop's
        # shape); it is inert without --adaptive_iters
        converge_eps=(float(getattr(args, "converge_eps", 0.0))
                      if getattr(args, "adaptive_iters", False) else 0.0),
    )


@dataclasses.dataclass(frozen=True)
class MADNet2Config:
    """MADNet2 family config (``raft_stereo_tpu/config.py:196-204``; the
    reference's core/madnet2/madnet2.py:9-34)."""

    num_blocks: int = 6  # pyramid feature blocks
    disp_scale: float = -20.0  # the reference's -20x disparity convention
    corr_radius: int = 2
    mixed_precision: bool = False
    fusion: bool = False  # MADNet2Fusion guidance branch
    attention_heads: int = 4


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Data-augmentation flags (reference: train_stereo.py:243-249)."""

    img_gamma: Optional[Tuple[float, float]] = None
    saturation_range: Optional[Tuple[float, float]] = None
    do_flip: Optional[str] = None  # 'h' | 'v' | None
    spatial_scale: Tuple[float, float] = (0.0, 0.0)
    noyjitter: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference: train_stereo.py:219-226,72-79)."""

    name: str = "raft-stereo"
    restore_ckpt: Optional[str] = None
    batch_size: int = 6
    train_datasets: Tuple[str, ...] = ("sceneflow",)
    lr: float = 2e-4
    num_steps: int = 100_000
    image_size: Tuple[int, int] = (320, 720)
    train_iters: int = 16
    valid_iters: int = 32
    wdecay: float = 1e-5
    loss_gamma: float = 0.9
    max_flow: float = 700.0
    grad_clip: float = 1.0
    validation_frequency: int = 10_000
    seed: int = 1234
    # Activation checkpointing of each refinement iteration in the backward.
    remat: bool = True

    def __post_init__(self):
        object.__setattr__(self, "train_datasets", tuple(self.train_datasets))
        object.__setattr__(self, "image_size", tuple(self.image_size))
