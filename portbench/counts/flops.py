"""Operation counts of a RAFT-Stereo forward, from the configuration and
the shapes alone.

Convolutions are counted by running the plain reference on the ``meta``
device (no data, no arithmetic) with a hook on each conv: 2 x output
elements x the input channels it reads x kernel area. The correlation is
counted from its definition: ``reg`` builds each level's all-pairs volume
once (2·D·W2 a feature pixel and level); ``alt`` recomputes, every
iteration, 2r+2 dot products of D a feature pixel and level (the taps the
linear interpolation reads). Element-wise work (norms, gates, the
upsampling's softmax) is left out, so the count is a floor of the work.
"""

from __future__ import annotations

import torch

from portbench.reference import model as ref


def _conv_flops(cfg: dict, batch: int, h: int, w: int, iters: int) -> float:
    m = ref.RAFTStereoReference(cfg).to("meta")
    total = [0.0]

    def hook(mod, inputs, out):
        cin = mod.in_channels_used or mod.in_channels
        kh, kw = mod.kernel_size
        total[0] += 2.0 * out.numel() * cin * kh * kw

    for mod in m.modules():
        if isinstance(mod, ref.Conv2d):
            mod.register_forward_hook(hook)
    img = torch.zeros((batch, h, w, 3), device="meta")
    with torch.no_grad():
        m(img, img, iters)
    return total[0]


def _corr_flops(cfg: dict, corr: str, batch: int, h: int, w: int, iters: int) -> float:
    f = 2 ** int(cfg["n_downsample"])
    hf, wf = h // f, w // f
    d, levels, r = int(cfg["fnet_dim"]), int(cfg["corr_levels"]), int(cfg["corr_radius"])
    if corr == "reg":
        w2 = [wf // 2 ** lvl for lvl in range(levels)]
        return 2.0 * d * batch * hf * wf * sum(w2)
    if corr == "alt":
        return 2.0 * d * (2 * r + 2) * levels * batch * hf * wf * iters
    raise ValueError(f"unknown corr implementation {corr!r}")


def forward_flops(cfg: dict, corr: str, iters: int, h: int, w: int, batch: int = 1) -> float:
    """Operations of one test-mode forward over ``batch`` pairs at the padded
    shape (h, w)."""
    return _conv_flops(cfg, batch, h, w, iters) + _corr_flops(cfg, corr, batch, h, w, iters)
