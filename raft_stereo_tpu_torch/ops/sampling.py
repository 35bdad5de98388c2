"""Grids, bilinear resize, pooling and convex upsampling (PyTorch port of
``raft_stereo_tpu/ops/sampling.py``).

Layouts: ``interp_bilinear`` and ``avg_pool2x`` work on the NCHW tensors
inside the modules; ``coords_grid``, ``avg_pool_w2``,
``bilinear_sampler`` and ``convex_upsample`` keep the JAX package's channel-last layout, the layout
the correlation state and the model's outputs use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 2] grid of (x, y) pixel coordinates."""
    y = torch.arange(ht, dtype=dtype, device=device)
    x = torch.arange(wd, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([xx, yy], dim=-1)
    return grid[None].expand(batch, ht, wd, 2)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [B, H, W, C] at pixel ``coords`` [B, Ho, Wo, 2] (x, y):
    align_corners=True, zeros outside (the JAX ``bilinear_sampler``,
    ``ops/sampling.py:51``)."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    dx = (x - x0f)[..., None].to(img.dtype)
    dy = (y - y0f)[..., None].to(img.dtype)
    x0, y0 = x0f.long(), y0f.long()
    flat = img.reshape(B, H * W, C)

    def gather(ix, iy):
        valid = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H))[..., None]
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)  # [B, Ho, Wo]
        out = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(B, idx[0].numel(), C))
        return out.reshape(*idx.shape, C) * valid.to(img.dtype)

    return (gather(x0, y0) * (1 - dx) * (1 - dy) + gather(x0 + 1, y0) * dx * (1 - dy)
            + gather(x0, y0 + 1) * (1 - dx) * dy + gather(x0 + 1, y0 + 1) * dx * dy)


def interp_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` with align_corners=True."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool, count_include_pad=True (NCHW)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def avg_pool_w2(x: torch.Tensor) -> torch.Tensor:
    """Average-pool by 2 along W of [..., W, C]; an odd trailing column is
    dropped (floor), as torch ``avg_pool2d([1, 2])`` does."""
    W2 = x.shape[-2] // 2
    xt = x[..., : 2 * W2, :]
    return xt.reshape(*xt.shape[:-2], W2, 2, xt.shape[-1]).mean(dim=-2)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int) -> torch.Tensor:
    """Learned convex upsampling.

    flow [B, H, W, D]; mask [B, H, W, 9·f·f] laid out as (9, f, f); returns
    [B, f·H, f·W, D]. Each fine pixel is a softmax-convex combination of the
    3x3 coarse neighbourhood of ``f · flow``, taps in ``F.unfold`` order.
    """
    B, H, W, D = flow.shape
    m = mask.permute(0, 3, 1, 2).reshape(B, 1, 9, factor, factor, H, W)
    m = torch.softmax(m, dim=2)
    up = F.unfold(factor * flow.permute(0, 3, 1, 2), [3, 3], padding=1)
    up = up.view(B, D, 9, 1, 1, H, W)
    up = torch.sum(m * up, dim=2)  # [B, D, f, f, H, W]
    up = up.permute(0, 4, 2, 5, 3, 1)  # B, H, fy, W, fx, D
    return up.reshape(B, factor * H, factor * W, D)
