"""Model construction and the test-mode forward helper (PyTorch port of
``raft_stereo_tpu/evaluate.py``'s ``load_model``, ``make_forward`` and
``add_model_args``).

Everything here runs on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request it raises.
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Optional, Union

import torch

from raft_stereo_tpu_torch.config import (
    CORR_IMPLEMENTATIONS,
    PRESET_FLAGS,
    RAFTStereoConfig,
    config_from_args,
)
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

logger = logging.getLogger(__name__)

# Modules the reference always builds but a model with fewer than three GRU
# levels never runs; the port does not build them.
_UNUSED_BELOW_3_LEVELS = ("cnet.layer5.", "cnet.outputs32.", "update_block.gru32.")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the CUDA card, which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def load_model(args_or_config, device=None, seed: int = 0,
               restore_ckpt: Optional[str] = None) -> RAFTStereo:
    """Build the model from a config or CLI args, initialised from a seeded
    ``torch.Generator``, optionally loading a reference ``.pth``, in eval
    mode on ``device``."""
    dev = resolve_device(device)
    if isinstance(args_or_config, RAFTStereoConfig):
        cfg = args_or_config
    else:
        cfg = config_from_args(args_or_config)
        restore_ckpt = restore_ckpt or getattr(args_or_config, "restore_ckpt", None)
    model = RAFTStereo(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    if restore_ckpt:
        sd = torch.load(restore_ckpt, map_location="cpu")
        sd = sd.get("state_dict", sd)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        if cfg.n_gru_layers < 3:
            sd = {k: v for k, v in sd.items() if not k.startswith(_UNUSED_BELOW_3_LEVELS)}
        model.load_state_dict(sd, strict=True)
    logger.info("Parameter Count: %d", sum(p.numel() for p in model.parameters()))
    return model.to(dev).eval()


def make_forward(model: RAFTStereo, iters: int) -> Callable:
    """Test-mode forward: (img1, img2) [B, H, W, 3] numpy or tensors →
    disp_up [B, f·H, f·W, 1] on the model's device."""
    dev = next(model.parameters()).device

    def forward(img1, img2) -> torch.Tensor:
        a = torch.as_tensor(img1, dtype=torch.float32, device=dev)
        b = torch.as_tensor(img2, dtype=torch.float32, device=dev)
        # the forward returns (lowres, disp_up) or, with converge_eps,
        # (lowres, disp_up, iters_executed)
        return model(a, b, iters=iters)[1]

    return forward


def add_model_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The architecture flags of the JAX package's ``add_model_args``."""
    parser.add_argument("--preset", choices=list(PRESET_FLAGS), default=None,
                        help="named model preset; explicit flags override")
    parser.add_argument("--restore_ckpt", default=None, help="reference checkpoint (.pth)")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--hidden_dims", nargs="+", type=int, default=[128] * 3)
    parser.add_argument("--corr_implementation", choices=list(CORR_IMPLEMENTATIONS), default="reg")
    parser.add_argument("--shared_backbone", action="store_true")
    parser.add_argument("--corr_levels", type=int, default=4)
    parser.add_argument("--corr_radius", type=int, default=4)
    parser.add_argument("--n_downsample", type=int, default=2)
    parser.add_argument("--context_norm", default="batch",
                        choices=["group", "batch", "instance", "none"])
    parser.add_argument("--slow_fast_gru", action="store_true")
    parser.add_argument("--n_gru_layers", type=int, default=3)
    parser.add_argument(
        "--fused_update", action="store_true",
        help="run each test-mode refinement step but the last as one fused step "
        "(correlation lookup, motion encoder, finest ConvGRU and flow head); on "
        "CUDA the hand-written kernel runs or the call raises, on the CPU its "
        "plain PyTorch version runs",
    )
    return parser
