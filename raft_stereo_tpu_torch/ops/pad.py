"""Pad-to-divisible input handling (port of ``raft_stereo_tpu/ops/pad.py``).

Channel-last [B, H, W, C] numpy arrays or torch tensors, replicate (edge)
padding.

Besides the per-image ``InputPadder``, this module holds the shape-bucket
vocabulary of the batched inference engine (``runtime.infer``):
``bucket_shape`` maps an (H, W) to the /``divis_by`` padded shape it is
served at, and ``BatchPadder`` pads a batch of images of possibly different
original shapes that share one bucket, each with its own offsets, so that
results unpad per item (slots past ``valid``, the pad-to-batch filler, are
dropped). All of it is numpy on the host.

``BatchPadder.bands`` writes a batch slot straight into a caller's buffer
(the engine's page-locked staging buffer), one host copy a pixel:
``edge_pad_rows`` fills a band of an item's padded rows by slice
assignment, so the bands of a batch can be written by several threads.
The bytes are those of ``np.pad(mode="edge")`` followed by ``np.stack``.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.nn.functional as F


def _pad_amounts(ht: int, wd: int, divis_by: int, mode: str,
                 divis_h: Optional[int] = None) -> List[int]:
    """(left, right, top, bottom) edge-pad amounts for one [H, W] shape.
    ``divis_h`` overrides the H divisor only (a spatially sharded bucket's);
    None keeps ``divis_by``."""
    dh = divis_by if divis_h is None else int(divis_h)
    pad_ht = (((ht // dh) + 1) * dh - ht) % dh
    pad_wd = (((wd // divis_by) + 1) * divis_by - wd) % divis_by
    if mode == "sintel":
        return [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
    return [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]


def spatial_divis(divis_by: int, num_spatial: int) -> int:
    """The H divisor of a bucket split into ``num_spatial`` row slabs: a
    multiple of ``divis_by`` that the slab count divides (their lcm)."""
    return math.lcm(int(divis_by), max(int(num_spatial), 1))


def bucket_shape(ht: int, wd: int, divis_by: int = 32,
                 divis_h: Optional[int] = None) -> Tuple[int, int]:
    """The /``divis_by``-padded (H, W) an image of this shape is served at:
    ``InputPadder``'s padded shape, so batched serving pads each member as
    the per-image path does. Images of different shapes can share one."""
    l, r, t, b = _pad_amounts(ht, wd, divis_by, "sintel", divis_h=divis_h)
    return ht + t + b, wd + l + r


def edge_pad_rows(dst: np.ndarray, x: np.ndarray, pads: Sequence[int],
                  rows: Optional[Tuple[int, int]] = None) -> None:
    """Rows ``rows`` (default all) of ``x`` [h, w, C] edge-padded by ``pads``
    (left, right, top, bottom), written into ``dst`` [h+t+b, w+l+r, C]:
    the values ``np.pad(x, ((t, b), (l, r), (0, 0)), mode="edge")`` has
    there, each written once (the columns' pads copy the row's own edge)."""
    l, r, t, _ = pads
    h, w = x.shape[:2]
    r0, r1 = (0, dst.shape[0]) if rows is None else rows
    i0, i1 = max(r0, t), min(r1, t + h)
    if i0 < i1:
        dst[i0:i1, l:l + w] = x[i0 - t:i1 - t]
    if r0 < min(r1, t):
        dst[r0:min(r1, t), l:l + w] = x[0]
    if max(r0, t + h) < r1:
        dst[max(r0, t + h):r1, l:l + w] = x[h - 1]
    if l:
        dst[r0:r1, :l] = dst[r0:r1, l:l + 1]
    if r:
        dst[r0:r1, l + w:] = dst[r0:r1, l + w - 1:l + w]


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


class BatchPadder:
    """Pads a batch of images that share one bucket.

    ``shapes`` are the members' original (H, W), all in one
    ``bucket_shape``. ``pad`` stacks one input slot into a host
    [B, Hb, Wb, C] array, edge-padding each item with its own offsets (the
    bytes ``InputPadder`` gives that image); ``unpad`` cuts item ``i``'s
    window out of a batched result, and ``unpad_all`` the first ``valid``
    items' (the rest are filler and never surface).
    """

    def __init__(self, shapes: Sequence[Tuple[int, int]], mode: str = "sintel",
                 divis_by: int = 32, divis_h: Optional[int] = None):
        if not shapes:
            raise ValueError("BatchPadder needs at least one shape")
        self.shapes = [tuple(s) for s in shapes]
        self.bucket = bucket_shape(*self.shapes[0], divis_by=divis_by, divis_h=divis_h)
        self._pads = []
        for ht, wd in self.shapes:
            if bucket_shape(ht, wd, divis_by, divis_h=divis_h) != self.bucket:
                raise ValueError(
                    f"shape {(ht, wd)} does not belong to bucket {self.bucket} "
                    f"(divis_by={divis_by}, divis_h={divis_h})")
            self._pads.append(_pad_amounts(ht, wd, divis_by, mode, divis_h=divis_h))

    def __len__(self):
        return len(self.shapes)

    def pad(self, items: Sequence[np.ndarray]) -> np.ndarray:
        """Stack one input slot: per-item [H, W, C] → host [B, Hb, Wb, C]."""
        if len(items) != len(self._pads):
            raise ValueError(f"expected {len(self._pads)} items, got {len(items)}")
        items = [np.asarray(x) for x in items]
        for x in items:
            if x.ndim != 3:
                raise ValueError(f"expected [H, W, C] items, got shape {x.shape}")
        out = np.empty(self.slot_shape(items), np.result_type(*items))
        for band in self.bands(out, items, 1):
            band()
        return out

    def slot_shape(self, items: Sequence[np.ndarray]) -> Tuple[int, int, int, int]:
        """The stacked [B, Hb, Wb, C] shape of one input slot."""
        return (len(self._pads), *self.bucket, items[0].shape[2])

    def bands(self, out: np.ndarray, items: Sequence[np.ndarray],
              per_item: int) -> List:
        """The writes of one slot of [H, W, C] ``items`` into ``out``, a
        [B, Hb, Wb, C] buffer of ``slot_shape(items)`` (e.g. page-locked),
        as callables over disjoint bands of rows (``per_item`` a member),
        for a caller to run on any threads; together they leave ``out``
        equal to ``pad(items)``, one host copy a pixel."""
        hb = self.bucket[0]
        step = -(-hb // max(int(per_item), 1))
        return [functools.partial(edge_pad_rows, out[i], x, pad, (r0, min(r0 + step, hb)))
                for i, (x, pad) in enumerate(zip(items, self._pads))
                for r0 in range(0, hb, step)]

    def unpad(self, batch: np.ndarray, i: int) -> np.ndarray:
        """Item ``i``'s original [H, W, C'] window of a batched result."""
        l, r, t, b = self._pads[i]
        ht, wd = batch.shape[1], batch.shape[2]
        return batch[i, t : ht - b, l : wd - r, :]

    def unpad_all(self, batch: np.ndarray, valid: int) -> List[np.ndarray]:
        """The first ``valid`` items' windows, in order; slots from
        ``valid`` on are pad-to-batch filler and never surface."""
        if not 0 <= valid <= len(self._pads):
            raise ValueError(f"valid={valid} out of range for batch of {len(self._pads)}")
        return [self.unpad(batch, i) for i in range(valid)]
