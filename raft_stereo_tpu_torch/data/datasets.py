"""Stereo datasets and the training loader (the port's own copy of
``raft_stereo_tpu/data/datasets.py``).

Index-based datasets that read (left, right, disparity) triples from the
reference's directory layouts, with the same roots, file orders, masks and
returned tuples: ``ds[i]`` (or ``ds.__getitem__(i, rng)``) is ``(img1,
img2, flow, valid)``, the images float32 [H, W, 3] in [0, 255], ``flow``
the float32 [H, W, 1] disparity and ``valid`` a float32 [H, W] mask. Dense
sets mark |disparity| < 512 valid, sparse ones take the reader's mask. With
``aug_params`` holding a ``crop_size`` the augmentor (``data/augmentor.py``)
runs, driven by the given ``numpy.random.Generator``.

  * evaluation: ETH3D, KITTI, FlyingThings3D's fixed seed-1000 400-image
    TEST split, Middlebury (F/H/Q and the 2014 scenes with their E/L
    exposures);
  * training: the SceneFlow TRAIN splits (FlyingThings3D, Monkaa,
    Driving), SintelStereo (disparities doubled across the two passes),
    FallingThings, TartanAir (winter-Easy left out), KITTI and Middlebury,
    ``__mul__`` replication and ``+`` concatenation;
  * ``PrefetchLoader``: the threaded shuffling batch loader with
    per-(epoch, position) rngs, host shards, fast-forward by index, and
    quarantine with resampling of corrupt samples.

Where the JAX package emits telemetry events, the port logs.
"""

from __future__ import annotations

import copy
import logging
import os
import os.path as osp
import queue
import threading
from glob import glob
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from raft_stereo_tpu_torch.data import frame_io
from raft_stereo_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor
from raft_stereo_tpu_torch.runtime import telemetry

logger = logging.getLogger(__name__)


class StereoDataset:
    """Index-based dataset (reference: core/stereo_datasets.py:21-121)."""

    # whether the set takes augmentation (a training set)
    trainable = True

    def __init__(self, aug_params=None, sparse: bool = False, reader=None):
        if aug_params is not None and not self.trainable:
            raise NotImplementedError(f"{type(self).__name__} is an evaluation set here: "
                                      "pass aug_params=None")
        self.augmentor = None
        self.sparse = sparse
        aug_params = dict(aug_params) if aug_params is not None else None
        self.img_pad = aug_params.pop("img_pad", None) if aug_params else None
        if aug_params is not None and "crop_size" in aug_params:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
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

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512
        img1, img2 = self._read_images(index)
        disp = np.asarray(disp, np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], axis=-1)
        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow, valid, rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)
        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        flow = flow.astype(np.float32)
        if self.sparse:
            valid = np.asarray(valid, np.float32)
        else:
            valid = ((np.abs(flow[..., 0]) < 512) & (np.abs(flow[..., 1]) < 512)).astype(
                np.float32)
        if self.img_pad is not None:
            pad_h, pad_w = self.img_pad
            img1 = np.pad(img1, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)))
            img2 = np.pad(img2, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)))
        return img1, img2, flow[..., :1], valid

    def __mul__(self, v: int):
        out = copy.copy(self)
        out.image_list = v * self.image_list
        out.disparity_list = v * self.disparity_list
        return out

    def __add__(self, other: "StereoDataset"):
        return _Concat([self, other])

    def __len__(self):
        return len(self.image_list)


class _Concat(StereoDataset):
    def __init__(self, parts: Sequence[StereoDataset]):
        super().__init__()
        self.parts = list(parts)
        for p in parts:
            self.image_list += p.image_list
            self.disparity_list += p.disparity_list

    def __getitem__(self, index, rng=None):
        for p in self.parts:
            if index < len(p):
                return p.__getitem__(index, rng)
            index -= len(p)
        raise IndexError(index)

    def __add__(self, other):
        return _Concat(self.parts + [other])

    def __mul__(self, v: int):
        # __getitem__ dispatches through the parts: replicate them, so that
        # len(self) and the reachable indices agree
        return _Concat(v * self.parts)


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D's TEST split (``things_test``) or the TRAIN splits of
    FlyingThings3D, Monkaa and Driving (``subsets``), reference :124-190.
    A TRAIN split takes ``aug_params`` for training; without them it serves
    full, unaugmented frames in order, as online adaptation reads them
    (``train_mad --adapt``, ``serve_adaptive --source dataset``)."""

    def __init__(self, aug_params=None, root="datasets", dstype="frames_finalpass",
                 things_test=False, subsets=("things",)):
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        unknown = set(subsets) - {"things", "monkaa", "driving"}
        if unknown:
            raise ValueError(f"unknown SceneFlow subsets {sorted(unknown)!r}")
        if not subsets:
            raise ValueError("subsets must name at least one of 'things'/'monkaa'/'driving'")
        if things_test:
            self._add_things("TEST")
            return
        if "things" in subsets:
            self._add_things("TRAIN")
        if "monkaa" in subsets:
            self._add_left(osp.join(self.root, "Monkaa", dstype, "*/left/*.png"))
        if "driving" in subsets:
            self._add_left(osp.join(self.root, "Driving", dstype, "*/*/*/left/*.png"))

    def _add_things(self, split="TRAIN"):
        original = len(self.disparity_list)
        base = osp.join(self.root, "FlyingThings3D")
        left = sorted(glob(osp.join(base, self.dstype, split, "*/*/left/*.png")))
        # the fixed seed-1000 400-image validation subset (reference :147-151)
        val_idxs = set(np.random.RandomState(1000).permutation(len(left))[:400])
        for idx, i1 in enumerate(left):
            if split == "TRAIN" or idx in val_idxs:
                self.image_list.append([i1, i1.replace("left", "right")])
                self.disparity_list.append(
                    i1.replace(self.dstype, "disparity").replace(".png", ".pfm"))
        logger.info("Added %d from FlyingThings %s", len(self.disparity_list) - original,
                    self.dstype)

    def _add_left(self, pattern):
        for i1 in sorted(glob(pattern)):
            self.image_list.append([i1, i1.replace("left", "right")])
            self.disparity_list.append(
                i1.replace(self.dstype, "disparity").replace(".png", ".pfm"))


class ETH3D(StereoDataset):
    trainable = False

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


class SintelStereo(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True, reader=frame_io.read_disp_sintel)
        im1 = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        im2 = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for i1, i2, d in zip(im1, im2, disp):
            if i1.split("/")[-2:] != d.split("/")[-2:]:
                raise ValueError(f"Sintel image {i1} paired with disparity {d}")
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/FallingThings"):
        super().__init__(aug_params, reader=frame_io.read_disp_falling_things)
        with open(osp.join(root, "filenames.txt")) as f:
            filenames = sorted(f.read().splitlines())
        for e in filenames:
            self.image_list.append(
                [osp.join(root, e), osp.join(root, e.replace("left.jpg", "right.jpg"))])
            self.disparity_list.append(osp.join(root, e.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    def __init__(self, aug_params=None, root="datasets", keywords=()):
        super().__init__(aug_params, reader=frame_io.read_disp_tartanair)
        with open(osp.join(root, "tartanair_filenames.txt")) as f:
            filenames = sorted(s for s in f.read().splitlines()
                               if "seasonsforest_winter/Easy" not in s)
            for kw in keywords:
                filenames = sorted(s for s in filenames if kw in s.lower())
        for e in filenames:
            self.image_list.append([osp.join(root, e), osp.join(root, e.replace("_left", "_right"))])
            self.disparity_list.append(osp.join(
                root, e.replace("image_left", "depth_left").replace("left.png", "left_depth.npy")))


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


# ------------------------------------------------------------------ loader


class _QuarantinedSample(RuntimeError):
    """A worker drew an index that is already quarantined (no IO paid)."""


class PrefetchLoader:
    """Threaded shuffling batch loader.

    N threads pull indices from a shared queue of the epoch's permutation,
    run the reader and augmentor, and the consumer assembles batches in
    position order. Each item's rng is a pure function of (seed, epoch,
    position), so the stream does not depend on which thread served it.
    ``shard_index``/``num_shards`` give each host a disjoint slice of every
    epoch.

    A sample whose read or augmentation raises is quarantined (not read
    again) and replaced by a deterministically resampled healthy one; the
    error surfaces when resampling keeps failing (``max_resamples`` draws)
    or when more than ``max_quarantine_frac`` of the epoch's slice is
    quarantined (a systemic fault: a wrong root or dead storage)."""

    def __init__(self, dataset: StereoDataset, batch_size: int,
                 num_workers: Optional[int] = None, seed: int = 1234, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1, prefetch: int = 4,
                 max_resamples: int = 3, max_quarantine_frac: float = 0.5):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.max_resamples = max_resamples
        self.max_quarantine_frac = max_quarantine_frac
        self.quarantined: set = set()
        self._quarantine_lock = threading.Lock()
        if num_workers is None:
            num_workers = max(int(os.environ.get("SLURM_CPUS_PER_TASK", 6)) - 2, 1)
        self.num_workers = num_workers

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _quarantine(self, index: int, err: BaseException, what: str = "sample") -> None:
        """Record ``index`` as bad (caller holds the lock)."""
        if index not in self.quarantined:
            self.quarantined.add(index)
            logger.warning("quarantining %s %d after %s: %s (%d total quarantined)", what,
                           index, type(err).__name__, err, len(self.quarantined))
            telemetry.emit("quarantine", index=int(index), reason=f"{type(err).__name__}: {err}",
                           total=len(self.quarantined))

    def _quarantine_and_resample(self, epoch: int, pos: int, index: int, err, domain=None):
        """Quarantine ``index`` and return a replacement item, or the
        exception to surface once the policy is exhausted. The replacement
        draws from this host's slice with an rng of (seed, epoch, position,
        attempt); which healthy index it picks depends on what is already
        quarantined, so only batches with substitutions may differ between
        runs."""
        if domain is None:
            domain = np.arange(len(self.dataset))
        n = len(domain)
        with self._quarantine_lock:
            self._quarantine(index, err)
            bad_here = sum(1 for j in domain if int(j) in self.quarantined)
            if bad_here > self.max_quarantine_frac * n:
                logger.error("quarantine is systemic: %d of %d samples of this epoch's slice",
                             bad_here, n)
                telemetry.emit("quarantine_systemic", quarantined=bad_here, domain=n,
                               threshold=self.max_quarantine_frac)
                return RuntimeError(
                    f"{bad_here}/{n} samples of this host's current epoch domain quarantined "
                    f"(> {self.max_quarantine_frac:.0%}): this is systemic (bad dataset root "
                    f"or dead storage), not sample bit-rot; last error: {err!r}")
        for attempt in range(self.max_resamples):
            with self._quarantine_lock:
                pool = [int(j) for j in domain if int(j) not in self.quarantined]
            if not pool:
                return err
            rng = np.random.default_rng(self.seed * 100003 + epoch * 1009 + pos * 31 + attempt + 1)
            j = pool[int(rng.integers(len(pool)))]
            try:
                return self.dataset.__getitem__(j, rng)
            except Exception as e:  # quarantine the replacement too, keep going
                err = e
                with self._quarantine_lock:
                    self._quarantine(j, e, "resampled")
        return err

    def stream(self, start_pos: int = 0):
        """Endless batch stream from global batch ordinal ``start_pos``:
        ordinal p is epoch p // len(self), position p % len(self), so one
        number (the manifest's ``stream_pos``) resumes the exact stream."""
        if len(self) == 0:
            raise ValueError("PrefetchLoader.stream: the loader yields zero batches per epoch "
                             "(dataset smaller than one batch?)")
        epoch, start_batch = divmod(start_pos, len(self))
        while True:
            yield from self.epoch(epoch, start_batch=start_batch)
            epoch += 1
            start_batch = 0

    def epoch(self, epoch: int = 0, start_batch: int = 0):
        """Yield dict batches for one epoch (stacked numpy, NHWC), skipping
        the first ``start_batch`` batches by index (no IO) with every item's
        rng unchanged."""
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(len(self.dataset))
        perm = perm[self.shard_index::self.num_shards]
        start_pos = min(start_batch * self.batch_size, len(perm))

        idx_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        for pos, i in enumerate(perm):
            if pos >= start_pos:
                idx_q.put((pos, int(i)))
        stop = threading.Event()
        # bounds how far the workers run ahead of the consumer, and so the
        # consumer's reorder buffer
        window = self.prefetch * self.batch_size + self.num_workers
        sem = threading.Semaphore(window)
        self._max_buffered = 0

        def worker():
            while not stop.is_set():
                if not sem.acquire(timeout=0.1):
                    continue
                try:
                    pos, i = idx_q.get_nowait()
                except queue.Empty:
                    sem.release()
                    return
                item_rng = np.random.default_rng(self.seed * 100003 + epoch * 1009 + int(pos))
                with self._quarantine_lock:
                    known_bad = int(i) in self.quarantined
                try:
                    if known_bad:
                        raise _QuarantinedSample(f"sample {int(i)} quarantined")
                    item = self.dataset.__getitem__(i, item_rng)
                except Exception as e:
                    item = self._quarantine_and_resample(epoch, pos, int(i), e, domain=perm)
                while not stop.is_set():
                    try:
                        out_q.put((pos, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            buf = {}
            next_pos = start_pos
            for _ in range(len(self) - start_batch):
                items = []
                while len(items) < self.batch_size:
                    while next_pos not in buf:
                        pos, item = out_q.get()
                        buf[pos] = item
                        self._max_buffered = max(self._max_buffered, len(buf))
                    item = buf.pop(next_pos)
                    next_pos += 1
                    sem.release()
                    if isinstance(item, Exception):
                        raise item
                    items.append(item)
                yield {
                    "img1": np.stack([x[0] for x in items]),
                    "img2": np.stack([x[1] for x in items]),
                    "flow": np.stack([x[2] for x in items]),
                    "valid": np.stack([x[3] for x in items]),
                }
        finally:
            stop.set()


def build_train_dataset(args, aug_params=None) -> StereoDataset:
    """The (possibly concatenated) dataset named by ``args.train_datasets``
    (reference: core/stereo_datasets.py:291-330)."""
    train_dataset = None
    for name in args.train_datasets:
        if name.startswith("middlebury_"):
            new = Middlebury(aug_params, split=name.replace("middlebury_", ""))
        elif name == "sceneflow":
            new = SceneFlowDatasets(aug_params, dstype="frames_finalpass")
        elif name in ("monkaa", "driving"):
            new = SceneFlowDatasets(aug_params, dstype="frames_finalpass", subsets=(name,))
        elif "kitti" in name:
            new = KITTI(aug_params)
        elif name == "sintel_stereo":
            new = SintelStereo(aug_params) * 140
        elif name == "falling_things":
            new = FallingThings(aug_params) * 5
        elif name.startswith("tartan_air"):
            new = TartanAir(aug_params, keywords=tuple(name.split("_")[2:]))
        else:
            raise ValueError(f"unknown dataset {name!r}")
        logger.info("Adding %d samples from %s", len(new), name)
        train_dataset = new if train_dataset is None else train_dataset + new
    return train_dataset


def fetch_dataloader(args, shard_index: int = 0, num_shards: int = 1) -> PrefetchLoader:
    """The training loader from a TrainConfig-like namespace (reference:
    core/stereo_datasets.py:291-330)."""
    aug_params = {
        "crop_size": tuple(args.image_size),
        "min_scale": args.spatial_scale[0],
        "max_scale": args.spatial_scale[1],
        "do_flip": False,
        "yjitter": not getattr(args, "noyjitter", False),
    }
    if getattr(args, "saturation_range", None) is not None:
        aug_params["saturation_range"] = args.saturation_range
    if getattr(args, "img_gamma", None) is not None:
        aug_params["gamma"] = args.img_gamma
    if getattr(args, "do_flip", None) is not None:
        aug_params["do_flip"] = args.do_flip
    train_dataset = build_train_dataset(args, aug_params)
    logger.info("Training with %d image pairs", len(train_dataset))
    return PrefetchLoader(train_dataset, batch_size=args.batch_size,
                          seed=getattr(args, "seed", 1234), shard_index=shard_index,
                          num_shards=num_shards)
