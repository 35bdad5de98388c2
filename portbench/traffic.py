"""The one traffic generator: every cell's inputs, from the seed and the
parameters in its ``workloads/<cell>.json``.

  * ``image_pool``: ``pool_pairs`` stereo pairs, each at a size of
    ``sizes`` in turn: a smooth random texture (box-blurred uniform noise
    in [0, 255]) seen by the left camera, and by the right camera shifted
    by a disparity in ``disparity_px``. Made on the device in one draw a
    pair and copied to host float32 [H, W, 3], the form the program's data
    readers hand to its engine.
  * ``order``: which pool pair each request sends, drawn from the seed.

Every seed gets the same work: the same sizes and the same set of
disparities, in the seed's own order; the seed also draws the textures.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pool_sizes(cell: dict) -> List[Tuple[int, int]]:
    sizes = [tuple(int(v) for v in s) for s in cell["sizes"]]
    return [sizes[i % len(sizes)] for i in range(int(cell["pool_pairs"]))]


def image_pool(cell: dict, seed: int, device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``pool_pairs`` (left, right) host float32 [H, W, 3] pairs."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    lo, hi = (int(v) for v in cell.get("disparity_px", (8, 64)))
    blur = int(cell.get("texture_blur", 5))
    sizes = pool_sizes(cell)
    # the same disparities for every seed, in the seed's order
    disp = np.linspace(lo, hi, len(sizes)).round().astype(int)
    disp = np.random.default_rng([int(seed), 3]).permutation(disp)
    pairs = []
    for (h, w), d in zip(sizes, disp):
        d = int(d)
        tex = torch.rand((1, 3, h, w + hi), generator=g, device=device)
        tex = F.avg_pool2d(tex, blur, stride=1, padding=blur // 2) * 255.0
        tex = tex[0].permute(1, 2, 0)
        left = tex[:, :w]
        right = tex[:, d:d + w]  # right(x) = left(x + d)
        pairs.append((left.contiguous().cpu().numpy(), right.contiguous().cpu().numpy()))
    return pairs


def order(pool: int, seed: int) -> Iterator[int]:
    """Pool indices without end: whole shuffled passes over the pool."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield from (int(i) for i in rng.permutation(pool))

