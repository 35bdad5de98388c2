"""Seeded weights, made on the device in a few large draws.

One state dict serves the program and the reference: the benchmark makes
it from the seed, the reference's module tree names it (the upstream
names, which the program keeps), and each side loads it.

Distribution: conv kernels normal with std sqrt(2 / fan_out) (He, fan
out), biases 0, norm scales 1 and shifts 0, running statistics (0, 1),
as the upstream initialisation draws them. Two groups are then damped by
the configuration's ``weights`` factors: the ConvGRUs' kernels
(``gru_scale``) and the flow head's output kernel (``flow_head_out_scale``).
Undamped random weights make the refinement loop chaotic: two float32
forwards that differ only in summation order drift apart by hundreds of
pixels over 32 iterations. A trained model's refinement contracts; the
damped draw keeps it stable enough that a difference between the program
and the reference measures rounding, not the chaos. The work, the shapes
and the kernels run are the same for any values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn


def _scale(name: str, wcfg: dict) -> float:
    if ".gru" in name:
        return float(wcfg.get("gru_scale", 1.0))
    if "flow_head.conv2" in name:
        return float(wcfg.get("flow_head_out_scale", 1.0))
    return 1.0


def make_state_dict(module: nn.Module, seed: int, device, wcfg: dict) -> Dict[str, torch.Tensor]:
    """The seeded state dict for ``module``'s names and shapes, on
    ``device``. Every conv kernel comes from one normal draw."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    names = dict(module.state_dict(keep_vars=True))
    kernels = [(k, v) for k, v in names.items() if k.endswith(".weight") and v.dim() == 4]
    total = sum(v.numel() for _, v in kernels)
    draw = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, v in kernels:
        n = v.numel()
        fan_out = v.shape[0] * v.shape[2] * v.shape[3]
        std = math.sqrt(2.0 / fan_out) * _scale(k, wcfg)
        out[k] = draw[off:off + n].view(v.shape).mul_(std)
        off += n
    for k, v in names.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            out[k] = torch.ones(v.shape, device=device)
        else:  # conv and norm biases, running means
            out[k] = torch.zeros(v.shape, device=device)
    return out
