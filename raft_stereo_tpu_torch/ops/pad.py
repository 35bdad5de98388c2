"""Pad-to-divisible input handling (port of ``raft_stereo_tpu/ops/pad.py``).

Channel-last [B, H, W, C] numpy arrays or torch tensors, replicate (edge)
padding.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch.nn.functional as F


def _pad_amounts(ht: int, wd: int, divis_by: int, mode: str) -> List[int]:
    """(left, right, top, bottom) edge-pad amounts for one [H, W] shape."""
    pad_ht = (((ht // divis_by) + 1) * divis_by - ht) % divis_by
    pad_wd = (((wd // divis_by) + 1) * divis_by - wd) % divis_by
    if mode == "sintel":
        return [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
    return [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]


class InputPadder:
    """Pads [B, H, W, C] images so H and W are divisible by ``divis_by``."""

    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8):
        self.ht, self.wd = dims[1], dims[2]
        self._pad = _pad_amounts(self.ht, self.wd, divis_by, mode)

    def pad(self, *inputs):
        l, r, t, b = self._pad
        out = []
        for x in inputs:
            if isinstance(x, np.ndarray):
                out.append(np.pad(x, ((0, 0), (t, b), (l, r), (0, 0)), mode="edge"))
            else:
                y = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode="replicate")
                out.append(y.permute(0, 2, 3, 1))
        return out

    def unpad(self, x):
        l, r, t, b = self._pad
        ht, wd = x.shape[1], x.shape[2]
        return x[:, t : ht - b, l : wd - r, :]
