"""Seeded weights of the MADNet2 family, made on the device in one draw.

One state dict serves the program and the reference
(``reference/madnet2_fusion.py``, whose module tree names it with the
fork's names, which the program keeps); each side loads it strictly.

Every parameter is drawn from the seed, the attention's projections and
LayerNorms included (an attention with zero projections passes its window
through unchanged, and no comparison could see it):

  * conv kernels: normal, std sqrt(2 / ((1 + 0.2^2) fan_in)), the gain
    that keeps the second moment through a conv and LeakyReLU(0.2); the
    first pyramid conv's by ``image_scale`` (the images enter in [0, 255]
    and no normalisation precedes it), so features come out of order 1;
  * the packed q | k | v projection and the output projection: normal,
    std sqrt(2 / (fan_in + fan_out)) (Glorot);
  * LayerNorm scales 1 + ``norm_std`` z, shifts ``norm_std`` z;
  * every bias: ``bias_std`` z;
  * each decoder's output conv damped by ``decoder_out_scale``, so the
    served disparities stay within the traffic's range, as the flow head
    of ``raftstereo`` is damped;
  * the attention's output projection scaled by ``attn_out_scale``, so its
    residual moves the answer by more than the configured precision's
    rounding does on every seed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

SLOPE = 0.2
FIRST_CONV = "feature_extraction.block1.0.0.weight"


def _std(name: str, shape, wcfg: dict) -> float:
    if name.endswith("in_proj_weight"):
        return math.sqrt(2.0 / (shape[0] + shape[1]))
    if name.endswith("out_proj.weight"):
        return math.sqrt(2.0 / (shape[0] + shape[1])) * float(wcfg.get("attn_out_scale", 1.0))
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        std = math.sqrt(2.0 / ((1.0 + SLOPE ** 2) * fan_in))
        if name == FIRST_CONV:
            std *= float(wcfg["image_scale"])
        if ".decoder.8." in name:  # each decoder's output conv
            std *= float(wcfg["decoder_out_scale"])
        return std
    if ".norm" in name:
        return float(wcfg["norm_std"])
    return float(wcfg["bias_std"])


def make_state_dict(module: nn.Module, seed: int, device, wcfg: dict) -> Dict[str, torch.Tensor]:
    """The seeded state dict for ``module``'s names and shapes, on
    ``device``, from one normal draw."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    names = dict(module.state_dict(keep_vars=True))
    draw = torch.randn(sum(v.numel() for v in names.values()), generator=g, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, v in names.items():
        z = draw[off:off + v.numel()].view(v.shape)
        off += v.numel()
        std = _std(k, tuple(v.shape), wcfg)
        if ".norm" in k and k.endswith(".weight"):
            out[k] = 1.0 + std * z
        else:
            out[k] = z * std
    return out
