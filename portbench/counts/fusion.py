"""Operation counts of a MADNet2-family forward, from the configuration
and the shapes alone, and the peak its share is taken of.

Convolutions are counted by running the plain reference
(``reference/madnet2_fusion.py``) on the ``meta`` device (no data, no
arithmetic) with a hook on each conv: 2 x output elements x the input
channels it reads x kernel area. Each level's all-pairs volume is counted
from its definition, 2·D·W² a row of H (D the level's feature channels),
and the Fusion variant's cross-attention as ``counts/xattn.py`` counts it.
The window's reads, the norms, the softmax and the upsampling are left
out, so the count is a floor of the work.
"""

from __future__ import annotations

import torch

from portbench.counts import xattn
from portbench.reference import madnet2_fusion as mref

# NVIDIA H100 SXM, dense TF32 tensor-core rate (data sheet, 700 W): the
# fastest rate the configuration's precision (TF32 convolutions, float32
# products elsewhere) can run at
TF32_FLOPS = 494.7e12


def conv_flops(fusion: bool, h: int, w: int, batch: int = 1) -> float:
    m = mref.MADNet2FusionReference(fusion).to("meta")
    total = [0.0]

    def hook(mod, inputs, out):
        kh, kw = mod.kernel_size
        total[0] += 2.0 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    for mod in m.modules():
        if isinstance(mod, mref.Conv):
            mod.register_forward_hook(hook)
    img = torch.zeros((batch, h, w, 3), device="meta")
    guide = torch.zeros((batch, h, w, 1), device="meta") if fusion else None
    with torch.no_grad():
        m(img, img, guide)
    return total[0]


def corr_flops(h: int, w: int, batch: int = 1) -> float:
    return float(sum(2 * mref.FEATURE_CHANNELS[k - 1] * (w >> k) ** 2 * (h >> k) * batch
                     for k in mref.LEVELS))


def forward_flops(fusion: bool, h: int, w: int, batch: int = 1) -> float:
    """Operations of one forward over ``batch`` pairs at the padded shape
    (h, w)."""
    return (conv_flops(fusion, h, w, batch) + corr_flops(h, w, batch)
            + (xattn.forward_flops(batch, h, w) if fusion else 0))
