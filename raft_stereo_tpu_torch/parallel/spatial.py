"""Row-sharded tensors of the spatial tier: the exchange that GSPMD inserts
for the JAX package when it partitions the forward over the mesh's
``spatial`` axis (``raft_stereo_tpu/parallel/mesh.py:147-159``), written
out by hand.

A sharded tensor is a list of row slabs, in row order, each on its own
device (a device may repeat: several slabs on one card, or on the CPU).
Module tensors are NCHW, so their rows are dim 2; the channel-last tensors
of the correlation state and the outputs pass ``dim=1``. Only shards that
hold rows take part: ``row_split`` gives the trailing shards of a short
bucket no rows, and the caller leaves them out.

  * ``row_split`` cuts H into whole units, so every pyramid level of every
    slab has whole rows; ``split`` places the slabs, ``gather`` joins them
    on the first slab's device.
  * ``halo`` / ``window``: rows taken from the neighbouring slabs, across
    as many slabs as it takes, with zero rows beyond the global ends (the
    convs' zero padding) or none there (``zeros=False``).
  * ``conv2d``: a conv of kernel k, stride s and padding p reads input rows
    ``[r0 - p, r1 - s + k - p)`` for its output rows ``[r0/s, r1/s)``: a
    halo of p rows above and ``max(k - p - s, 0)`` below, then the conv
    with no row padding.
  * ``instance_norm`` / ``group_norm``: each shard's fp32 Σx and Σx², added
    on the first slab's device and sent back, then the module's formula.
  * ``avg_pool2x`` (one halo row above), ``interp_bilinear``
    (``align_corners=True`` in global row coordinates) and
    ``convex_upsample`` (one halo row each side).

The correlation volume and its lookups never mix rows and need no
exchange. A copy to another device is ``.to(device, non_blocking=True)``;
on one device it is no copy at all.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def row_split(H: int, unit: int, k: int) -> List[Tuple[int, int]]:
    """``k`` row ranges ``[r0, r1)`` covering ``[0, H)`` in whole units of
    ``unit`` rows, spread as evenly as possible (the first shards take the
    extra units). With fewer units than shards the trailing ranges are
    empty."""
    if k < 1:
        raise ValueError(f"row_split needs k >= 1 shards, got {k}")
    if unit < 1 or H % unit:
        raise ValueError(f"row_split: H={H} is not a whole number of {unit}-row units")
    base, extra = divmod(H // unit, k)
    bounds, r = [], 0
    for i in range(k):
        n = (base + (i < extra)) * unit
        bounds.append((r, r + n))
        r += n
    return bounds


def active(bounds: Sequence[Tuple[int, int]]) -> int:
    """How many of the ranges hold rows (the leading ones)."""
    return sum(1 for r0, r1 in bounds if r1 > r0)


def split(x: torch.Tensor, bounds: Sequence[Tuple[int, int]], devices: Sequence,
          dim: int = 2) -> List[torch.Tensor]:
    """The non-empty row ranges of ``x``, each on its device."""
    return [x.narrow(dim, r0, r1 - r0).to(dev, non_blocking=True)
            for (r0, r1), dev in zip(bounds, devices) if r1 > r0]


def gather(slabs: Sequence[torch.Tensor], dim: int = 2) -> torch.Tensor:
    """The slabs joined on the first slab's device."""
    dev = slabs[0].device
    return torch.cat([s.to(dev, non_blocking=True) for s in slabs], dim=dim)


def _starts(slabs: Sequence[torch.Tensor], dim: int) -> List[int]:
    out, r = [], 0
    for s in slabs:
        out.append(r)
        r += s.shape[dim]
    return out + [r]


def window(slabs: Sequence[torch.Tensor], i: int, lo: int, hi: int, dim: int = 2,
           zeros: bool = True) -> torch.Tensor:
    """Global rows ``[lo, hi)`` on slab ``i``'s device, taken from whichever
    slabs hold them; rows outside ``[0, H)`` are zeros, or left out with
    ``zeros=False``."""
    starts = _starts(slabs, dim)
    H = starts[-1]
    ref = slabs[i]
    dev = ref.device

    def zero_rows(n):
        shape = list(ref.shape)
        shape[dim] = n
        return torch.zeros(shape, dtype=ref.dtype, device=dev)

    pieces = []
    if zeros and lo < 0:
        pieces.append(zero_rows(-lo))
    for j, s in enumerate(slabs):
        a, b = max(lo, starts[j]), min(hi, starts[j + 1])
        if a < b:
            pieces.append(s.narrow(dim, a - starts[j], b - a).to(dev, non_blocking=True))
    if zeros and hi > H:
        pieces.append(zero_rows(hi - H))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def halo(slabs: Sequence[torch.Tensor], above: int, below: int, dim: int = 2,
         zeros: bool = True) -> List[torch.Tensor]:
    """Each slab extended by ``above`` rows before it and ``below`` after."""
    if above == 0 and below == 0:
        return list(slabs)
    starts = _starts(slabs, dim)
    return [window(slabs, i, starts[i] - above, starts[i + 1] + below, dim, zeros)
            for i in range(len(slabs))]


def conv2d(slabs: Sequence[torch.Tensor], mods: Sequence[torch.nn.Conv2d],
           in_slice: slice = slice(None), out_slice: slice = slice(None)) -> List[torch.Tensor]:
    """``mods[i]`` (slab i's copy of one conv, zero padded) on each slab, in
    the slab's dtype, restricted to some input / output channels (the
    port's ``_conv_x``)."""
    m = mods[0]
    k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
    ext = halo(slabs, p, max(k - p - s, 0))
    out = []
    for x, mod in zip(ext, mods):
        w = mod.weight[out_slice, in_slice].to(x.dtype)
        b = None if mod.bias is None else mod.bias[out_slice].to(x.dtype)
        out.append(F.conv2d(x, w, b, stride=mod.stride, padding=(0, mod.padding[1]),
                            dilation=mod.dilation, groups=mod.groups))
    return out


def all_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' ``parts``, formed on the first part's device
    and sent back to each part's."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev, non_blocking=True)
    return [total.to(p.device, non_blocking=True) for p in parts]


def moments(slabs: Sequence[torch.Tensor], groups: int = 0) -> List[torch.Tensor]:
    """Each slab's copy of the global fp32 (E[x], E[x²]) of every sample and
    channel (``groups`` 0), or of every sample and channel group,
    [2, B, C or G]."""
    parts = []
    n = 0
    for x in slabs:
        B, C, h, W = x.shape
        xf = x.float() if not groups else x.float().reshape(B, groups, C // groups * h * W)
        dims = (2, 3) if not groups else (2,)
        parts.append(torch.stack([xf.sum(dim=dims), xf.square().sum(dim=dims)]))
        n += (C // groups if groups else 1) * h * W
    return [m / n for m in all_sum(parts)]


def instance_norm(slabs: Sequence[torch.Tensor], eps: float) -> List[torch.Tensor]:
    """The port's ``InstanceNorm`` over the whole image."""
    out = []
    for x, m in zip(slabs, moments(slabs)):
        mean, msq = m[0][..., None, None], m[1][..., None, None]
        inv = torch.rsqrt((msq - mean.square()).clamp_min(0.0) + eps)
        out.append(x * inv.to(x.dtype) + (-mean * inv).to(x.dtype))
    return out


def group_norm(slabs: Sequence[torch.Tensor], mods: Sequence[torch.nn.GroupNorm]
               ) -> List[torch.Tensor]:
    """The port's ``GroupNorm`` (fp32 statistics, affine, cast back) over the
    whole image."""
    G = mods[0].num_groups
    out = []
    for x, m, mod in zip(slabs, moments(slabs, G), mods):
        B, C, h, W = x.shape
        mean, msq = m[0][..., None], m[1][..., None]
        inv = torch.rsqrt((msq - mean.square()).clamp_min(0.0) + mod.eps)
        y = ((x.float().reshape(B, G, -1) - mean) * inv).reshape(B, C, h, W)
        out.append((y * mod.weight[:, None, None] + mod.bias[:, None, None]).to(x.dtype))
    return out


def avg_pool2x(slabs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """3x3 stride-2 pad-1 average pool, ``count_include_pad=True``: one halo
    row above (zeros at the top, as the pad)."""
    return [F.avg_pool2d(x, 3, stride=2, padding=(0, 1)) for x in halo(slabs, 1, 0)]


def interp_bilinear(slabs: Sequence[torch.Tensor], rows: Sequence[int],
                    width: int) -> List[torch.Tensor]:
    """Bilinear resize, ``align_corners=True``, of the coarse slabs to
    slabs of ``rows[i]`` rows and ``width`` columns: fine row y samples the
    coarse image at ``y·(Hc − 1)/(Hf − 1)`` in global coordinates, from the
    coarse rows around it (its own slab's and a halo row or so). Computed
    in fp32, cast once to the slabs' dtype."""
    Hc, Hf = sum(s.shape[2] for s in slabs), sum(rows)
    if Hc == Hf and slabs[0].shape[3] == width:
        return list(slabs)
    # the scale as torch forms it: the float32 quotient
    scale = float(np.float32(Hc - 1) / np.float32(Hf - 1)) if Hf > 1 else 0.0
    out, f0 = [], 0
    for i, n in enumerate(rows):
        dev = slabs[i].device
        src = torch.arange(f0, f0 + n, dtype=torch.float32, device=dev) * scale
        h0 = src.long().clamp_max(Hc - 1)
        h1 = h0 + (h0 < Hc - 1).long()
        # the coarse rows read, from the same float32 products on the host
        ends = np.array([f0, f0 + n - 1], dtype=np.float32) * np.float32(scale)
        lo, hi = int(ends[0]), min(int(ends[1]) + 2, Hc)
        x = window(slabs, i, lo, hi).float()
        x = F.interpolate(x, size=(x.shape[2], width), mode="bilinear", align_corners=True)
        l1 = (src - h0.float())[:, None]
        y = x[:, :, h0 - lo] * (1.0 - l1) + x[:, :, h1 - lo] * l1
        out.append(y.to(slabs[i].dtype))
        f0 += n
    return out


def convex_upsample(flow: Sequence[torch.Tensor], mask: Sequence[torch.Tensor],
                    factor: int) -> List[torch.Tensor]:
    """``ops.sampling.convex_upsample`` of channel-last flow slabs [B, h, W,
    D] with their masks [B, h, W, 9·f·f]: the 3x3 neighbourhood takes one
    halo row of the flow above and below (zeros at the ends, as unfold's
    padding)."""
    out = []
    for ext, m in zip(halo(flow, 1, 1, dim=1), mask):
        B, h, W, _ = m.shape
        D = ext.shape[-1]
        m = torch.softmax(m.permute(0, 3, 1, 2).reshape(B, 1, 9, factor, factor, h, W), dim=2)
        up = F.unfold(factor * ext.permute(0, 3, 1, 2), [3, 3], padding=(0, 1))
        up = torch.sum(m * up.view(B, D, 9, 1, 1, h, W), dim=2)  # [B, D, f, f, h, W]
        out.append(up.permute(0, 4, 2, 5, 3, 1).reshape(B, factor * h, factor * W, D))
    return out
