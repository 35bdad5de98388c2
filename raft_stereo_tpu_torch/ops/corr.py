"""1-D correlation volumes, pyramids and windowed lookups (PyTorch port of
``raft_stereo_tpu/ops/corr.py``).

Feature maps are channel-last [B, H, W, D] and coordinates [B, H, W1], as
in the JAX package; every lookup returns [B, H, W1, L·(2r+1)] level-major.

  * ``corr_volume`` + ``corr_lookup_reg``: the full-volume path (``reg``).
  * ``corr_lookup_alt_plain``: the memory-efficient recompute-at-offsets
    path (``alt``), written with plain tensor ops. It is the plain version
    of the CUDA kernel behind ``ops.alt_corr.corr_lookup_alt``, which
    ``CorrFn`` calls for the ``alt`` backends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch

from raft_stereo_tpu_torch.ops.sampling import avg_pool_w2


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation along W: [B,H,W1,D] x [B,H,W2,D] → [B,H,W1,W2]
    in fp32, scaled by 1/sqrt(D)."""
    D = fmap1.shape[-1]
    corr = torch.einsum("bhxd,bhyd->bhxy", fmap1.float(), fmap2.float())
    return corr / math.sqrt(D)


def _window_offsets(radius: int, coords_x: torch.Tensor) -> torch.Tensor:
    return torch.linspace(-radius, radius, 2 * radius + 1,
                          dtype=coords_x.dtype, device=coords_x.device)


def _gather_linear_1d(line: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``line`` [..., W] at ``x`` [..., N], zero
    outside [0, W-1] (grid_sample zeros padding, align_corners=True)."""
    W = line.shape[-1]
    x0 = torch.floor(x)
    dx = (x - x0).to(line.dtype)
    i0 = x0.long()
    i1 = i0 + 1
    v0 = torch.gather(line, -1, i0.clamp(0, W - 1))
    v1 = torch.gather(line, -1, i1.clamp(0, W - 1))
    in0 = ((i0 >= 0) & (i0 <= W - 1)).to(line.dtype)
    in1 = ((i1 >= 0) & (i1 <= W - 1)).to(line.dtype)
    return v0 * in0 * (1.0 - dx) + v1 * in1 * dx


def corr_lookup_reg(pyramid: Sequence[torch.Tensor], coords_x: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """Sample a (2r+1)-window from each volume level pyramid[i]
    [B, H, W1, W2/2^i] at x/2^i + offsets."""
    dx = _window_offsets(radius, coords_x)
    out = []
    for i, corr in enumerate(pyramid):
        x = coords_x[..., None] / (2 ** i) + dx
        out.append(_gather_linear_1d(corr, x))
    return torch.cat(out, dim=-1)


def corr_lookup_alt_plain(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                          coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    """Recompute-at-offsets lookup: for each level and each of the 2r+1
    offsets, interpolate fmap2 along W at x/2^i + dx and dot with fmap1.
    The same values as sampling the pooled full volume, which is never built.
    """
    B, H, W1, D = fmap1.shape
    K = 2 * radius + 1
    dx = _window_offsets(radius, coords_x)
    scale = 1.0 / math.sqrt(D)
    rows = torch.arange(B * H, device=fmap1.device).view(B, H, 1, 1)
    out = []
    for i, fmap2 in enumerate(fmap2_pyramid):
        W2 = fmap2.shape[2]
        flat = fmap2.reshape(B * H * W2, D)
        x = coords_x[..., None] / (2 ** i) + dx  # [B, H, W1, K]
        x0 = torch.floor(x)
        frac = (x - x0).to(fmap1.dtype)
        i0 = x0.long()

        def tap(idx):
            valid = ((idx >= 0) & (idx < W2)).to(fmap1.dtype)
            g = flat[(rows * W2 + idx.clamp(0, W2 - 1)).reshape(-1)]
            g = g.view(B, H, W1, K, D)
            c = torch.einsum("bhxkd,bhxd->bhxk", g, fmap1)
            return c * valid

        corr = tap(i0) * (1.0 - frac) + tap(i0 + 1) * frac
        out.append(corr * scale)
    return torch.cat(out, dim=-1)


def pool_fmap_pyramid(fmap2: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Width-only feature pyramid for the alt path (floor halving)."""
    pyr = [fmap2]
    for _ in range(num_levels - 1):
        pyr.append(avg_pool_w2(pyr[-1]))
    return pyr


@dataclasses.dataclass
class CorrFn:
    """Correlation lookup bound to one pair: built once, called per
    iteration with coords [B, H, W, 2] (x channel used) or [B, H, W]."""

    backend: str
    radius: int
    pyramid: Optional[Sequence[torch.Tensor]] = None  # reg: volume pyramid
    fmap1: Optional[torch.Tensor] = None  # alt: features
    fmap2_pyramid: Optional[Sequence[torch.Tensor]] = None

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        coords_x = coords[..., 0] if coords.ndim == 4 else coords
        if self.backend in ("reg", "reg_pallas"):
            return corr_lookup_reg(self.pyramid, coords_x, self.radius)
        if self.backend in ("alt", "alt_pallas"):
            from raft_stereo_tpu_torch.ops import alt_corr

            return alt_corr.corr_lookup_alt(
                self.fmap1, self.fmap2_pyramid, coords_x, self.radius
            )
        raise ValueError(f"unknown corr backend {self.backend!r}")


def make_corr_fn(backend: str, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int, radius: int) -> CorrFn:
    """Per-pair correlation state for the chosen backend (channel-last
    features). ``reg``/``alt`` cast the features to fp32 as the reference
    does under mixed precision; ``reg_pallas`` and ``alt_pallas`` pool in
    the compute dtype. The alt kernel takes fp32, so ``alt_pallas`` upcasts
    its pooled levels once here (the JAX package upcasts on every call, to
    the same values). Every volume is fp32.
    """
    if backend in ("reg", "alt"):
        fmap1 = fmap1.float()
        fmap2 = fmap2.float()
    if backend in ("reg", "reg_pallas"):
        pyramid = [corr_volume(fmap1, f2p) for f2p in pool_fmap_pyramid(fmap2, num_levels)]
        return CorrFn(backend=backend, radius=radius, pyramid=pyramid)
    if backend in ("alt", "alt_pallas"):
        pyramid = [f2p.float() for f2p in pool_fmap_pyramid(fmap2, num_levels)]
        return CorrFn(backend=backend, radius=radius, fmap1=fmap1.float(),
                      fmap2_pyramid=pyramid)
    raise ValueError(f"unknown corr backend {backend!r}")
