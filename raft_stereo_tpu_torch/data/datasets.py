"""Evaluation datasets (the port's own copy of the evaluation side of
``raft_stereo_tpu/data/datasets.py``).

Index-based datasets that read (left, right, disparity) triples from the
reference's directory layouts, with the same roots, file orders, masks and
returned tuples: ``ds[i]`` is ``(img1, img2, flow, valid)``, the images
float32 [H, W, 3] in [0, 255], ``flow`` the float32 [H, W, 1] disparity and
``valid`` a float32 [H, W] mask. Dense sets mark |disparity| < 512 valid,
sparse ones take the reader's mask.

Evaluation mode only: augmentation and the training loader come with
training.
"""

from __future__ import annotations

import logging
import os.path as osp
from glob import glob
from pathlib import Path
from typing import List

import numpy as np

from raft_stereo_tpu_torch.data import frame_io

logger = logging.getLogger(__name__)


class StereoDataset:
    """Index-based dataset in evaluation mode (no augmentation)."""

    def __init__(self, aug_params=None, sparse: bool = False, reader=None):
        if aug_params is not None:
            raise NotImplementedError("augmentation comes with training: pass aug_params=None")
        self.sparse = sparse
        self.disparity_reader = reader or frame_io.read_gen
        self.disparity_list: List[str] = []
        self.image_list: List[List[str]] = []

    def _read_images(self, index):
        img1 = np.asarray(frame_io.read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.asarray(frame_io.read_gen(self.image_list[index][1])).astype(np.uint8)
        if img1.ndim == 2:  # grayscale
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        return img1[..., :3], img2[..., :3]

    def __getitem__(self, index):
        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512
        img1, img2 = self._read_images(index)
        disp = np.asarray(disp, np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], axis=-1)
        if self.sparse:
            valid = np.asarray(valid, np.float32)
        else:
            valid = ((np.abs(flow[..., 0]) < 512) & (np.abs(flow[..., 1]) < 512)).astype(
                np.float32)
        return img1.astype(np.float32), img2.astype(np.float32), flow[..., :1], valid

    def __len__(self):
        return len(self.image_list)


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D's fixed 400-image TEST subset (seed 1000)."""

    def __init__(self, aug_params=None, root="datasets", dstype="frames_finalpass",
                 things_test=False):
        super().__init__(aug_params)
        if not things_test:
            raise NotImplementedError("the SceneFlow training splits come with training: "
                                      "pass things_test=True")
        base = osp.join(root, "FlyingThings3D")
        left = sorted(glob(osp.join(base, dstype, "TEST", "*/*/left/*.png")))
        val_idxs = set(np.random.RandomState(1000).permutation(len(left))[:400])
        for idx, i1 in enumerate(left):
            if idx in val_idxs:
                self.image_list.append([i1, i1.replace("left", "right")])
                self.disparity_list.append(
                    i1.replace(dstype, "disparity").replace(".png", ".pfm"))
        logger.info("Added %d from FlyingThings %s", len(self.disparity_list), dstype)


class ETH3D(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/ETH3D", split="training"):
        super().__init__(aug_params, sparse=True)
        im0 = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        im1 = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:
            disp = [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")] * len(im0)
        for i0, i1, d in zip(im0, im1, disp):
            self.image_list.append([i0, i1])
            self.disparity_list.append(d)


class KITTI(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/KITTI", image_set="training"):
        super().__init__(aug_params, sparse=True, reader=frame_io.read_disp_kitti)
        im1 = sorted(glob(osp.join(root, image_set, "image_2/*_10.png")))
        im2 = sorted(glob(osp.join(root, image_set, "image_3/*_10.png")))
        if image_set == "training":
            disp = sorted(glob(osp.join(root, "training", "disp_occ_0/*_10.png")))
        else:
            disp = [osp.join(root, "training/disp_occ_0/000085_10.png")] * len(im1)
        for i1, i2, d in zip(im1, im2, disp):
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class Middlebury(StereoDataset):
    """MiddEval3's official training scenes at resolution F, H or Q, or the
    2014 scenes with their E and L exposure variants."""

    def __init__(self, aug_params=None, root="datasets/Middlebury", split="F"):
        super().__init__(aug_params, sparse=True, reader=frame_io.read_disp_middlebury)
        if split not in ("F", "H", "Q", "2014"):
            raise ValueError(f"Middlebury split must be F, H, Q or 2014, got {split!r}")
        if split == "2014":
            for scene in sorted(Path(osp.join(root, "2014")).glob("*")):
                for s in ("E", "L", ""):
                    self.image_list.append([str(scene / "im0.png"), str(scene / f"im1{s}.png")])
                    self.disparity_list.append(str(scene / "disp0.pfm"))
            return
        official = Path(osp.join(root, "MiddEval3/official_train.txt")).read_text().splitlines()
        names = [osp.basename(p) for p in glob(osp.join(root, "MiddEval3/trainingF/*"))
                 if any(s in p.split("/") for s in official)]
        for name in sorted(names):
            base = osp.join(root, "MiddEval3", f"training{split}", name)
            self.image_list.append([osp.join(base, "im0.png"), osp.join(base, "im1.png")])
            self.disparity_list.append(osp.join(base, "disp0GT.pfm"))
        if not self.image_list:
            raise ValueError(f"no Middlebury scenes under {root} (split {split})")
