"""Training, the data layer: the port's native photometric copy, its
cv2-free resize, the dense and sparse augmentors, the training datasets
and the ``PrefetchLoader`` against the JAX package, on the CPU.

Tolerances: the native copy is bitwise; the port's bilinear resize against
``cv2.resize`` (which the JAX augmentor calls) within one level on 8-bit
images (cv2's vector and scalar fixed-point paths round apart by one) and
1e-4 of the scale on float flow. The augmentors draw from the same
``default_rng`` seeds: the rng states must agree afterwards (the same
draws in the same order, so the same crop offsets), images within one
level, flow within 1e-4 relative.
"""

import numpy as np
import pytest

import fixture_trees as ft
from raft_stereo_tpu import native as jax_native
from raft_stereo_tpu.data import augmentor as jaug
from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu_torch import native
from raft_stereo_tpu_torch.data import augmentor, datasets

IMG_TOL = 1  # levels
FLOW_RTOL = 1e-4


def _rng_state(rng):
    return rng.bit_generator.state["state"]


def _close_images(got, want):
    assert got.shape == want.shape
    return np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= IMG_TOL


def _close_flow(got, want):
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    return np.abs(got - want).max() <= FLOW_RTOL * scale


# ----------------------------------------------------------------- native


def test_native_copy_is_bitwise_the_jax_packages():
    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for args in [(1.1, 0.9, 1.2, 10.0, 0.9, 1.05), (0.6, 1.4, 0.0, -28.6, 1.0, 1.0),
                 (1.4, 0.6, 1.4, 0.0, 1.3, 0.8), (1.0, 1.0, 1.0, 0.0, 1.0, 1.0)]:
        got = native.fused_photometric(img.copy(), *args)
        want = jax_native.fused_photometric(img.copy(), *args)
        assert np.array_equal(got, want), args
    rects = np.asarray([[3, 4, 60, 50], [40, 30, 55, 70]], np.int64)
    mean = img.reshape(-1, 3).mean(axis=0).astype(np.float32)
    got, want = img.copy(), img.copy()
    native.eraser_fill(got, mean, rects)
    jax_native.eraser_fill(want, mean, rects)
    assert np.array_equal(got, want) and not np.array_equal(got, img)
    assert native.lib_path().is_file()  # built at first use


def test_native_rebuilds_a_library_that_does_not_load(tmp_path, monkeypatch):
    """A library under the current name that does not load (left by
    another host) is built anew; another machine gives another name."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    path = native.lib_path()
    path.write_bytes(b"not a shared library")
    img = np.random.RandomState(2).randint(0, 256, (8, 12, 3)).astype(np.uint8)
    want = img.copy()
    native.eraser_fill(want, np.zeros(3, np.float32), np.asarray([[1, 2, 4, 3]], np.int64))
    assert want[2:5, 1:5].max() == 0 and path.read_bytes()[:4] == b"\x7fELF"
    monkeypatch.setattr(native.platform, "machine", lambda: "another-machine")
    assert native.lib_path() != path


def test_native_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        native.fused_photometric(np.zeros((4, 4, 3), np.float32), 1, 1, 1, 0)
    with pytest.raises(ValueError):
        native.eraser_fill(np.zeros((4, 8, 3), np.uint8)[:, ::2], np.zeros(3), np.zeros((0, 4)))


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("shape,fx,fy", [((40, 64, 3), 1.37, 1.0), ((61, 97, 3), 0.83, 0.91),
                                         ((37, 51, 3), 1.91, 1.23), ((100, 80, 2), 0.61, 1.49)])
def test_resize_matches_cv2(shape, fx, fy):
    import cv2

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    flow = (rng.standard_normal(shape[:2] + (2,)) * 30).astype(np.float32)
    got = augmentor.resize_linear(img, fx, fy)
    want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    assert _close_images(got, want) and got.dtype == np.uint8
    got_f = augmentor.resize_linear(flow, fx, fy)
    want_f = cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    assert _close_flow(got_f, want_f)


# --------------------------------------------------------------- augmentors


def _pair(seed, H=120, W=160, sparse=False):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    flow = np.stack([rng.uniform(0, 40, (H, W)), np.zeros((H, W))], -1).astype(np.float32)
    valid = rng.random((H, W)) > 0.3 if sparse else None
    return img1, img2, flow, valid


DENSE_CASES = [
    dict(crop_size=(64, 96), min_scale=-0.2, max_scale=0.4, do_flip=False, yjitter=True,
         saturation_range=(0, 1.4)),
    dict(crop_size=(64, 96), min_scale=0.0, max_scale=0.0, do_flip="h", yjitter=False),
    dict(crop_size=(48, 80), min_scale=-0.4, max_scale=0.2, do_flip="v", yjitter=True,
         gamma=(0.8, 1.2, 0.9, 1.1)),
    dict(crop_size=(48, 80), min_scale=-0.2, max_scale=0.5, do_flip="hf", yjitter=False),
]


@pytest.mark.parametrize("case", range(len(DENSE_CASES)))
def test_flow_augmentor_matches_jax(case):
    params = DENSE_CASES[case]
    ours, theirs = augmentor.FlowAugmentor(**params), jaug.FlowAugmentor(**params)
    for seed in range(6):
        img1, img2, flow, _ = _pair(seed)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ours(img1.copy(), img2.copy(), flow.copy(), r1)
        want = theirs(img1.copy(), img2.copy(), flow.copy(), r2)
        assert _rng_state(r1) == _rng_state(r2)  # the same draws, so the same crops
        assert _close_images(got[0], want[0]) and _close_images(got[1], want[1])
        assert _close_flow(got[2], want[2])


@pytest.mark.parametrize("do_flip", [False, "h"])
def test_sparse_flow_augmentor_matches_jax(do_flip):
    params = dict(crop_size=(64, 96), min_scale=-0.2, max_scale=0.4, do_flip=do_flip,
                  saturation_range=(0, 1.4))
    ours, theirs = augmentor.SparseFlowAugmentor(**params), jaug.SparseFlowAugmentor(**params)
    for seed in range(6):
        img1, img2, flow, valid = _pair(10 + seed, sparse=True)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ours(img1.copy(), img2.copy(), flow.copy(), valid.copy(), r1)
        want = theirs(img1.copy(), img2.copy(), flow.copy(), valid.copy(), r2)
        assert _rng_state(r1) == _rng_state(r2)
        assert _close_images(got[0], want[0]) and _close_images(got[1], want[1])
        assert _close_flow(got[2], want[2]) and np.array_equal(got[3], want[3])


# ---------------------------------------------------------------- datasets


AUG = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4, "do_flip": False,
       "yjitter": True, "saturation_range": (0, 1.4)}
SPARSE_AUG = dict(AUG, yjitter=False)


def _train_sets(mod):
    return {
        "sceneflow": lambda: mod.SceneFlowDatasets(AUG),
        "monkaa": lambda: mod.SceneFlowDatasets(AUG, subsets=("monkaa", "driving")),
        "sintel": lambda: mod.SintelStereo(SPARSE_AUG),
        "falling_things": lambda: mod.FallingThings(AUG),
        "tartan_air": lambda: mod.TartanAir(AUG, keywords=("easy",)),
        "kitti": lambda: mod.KITTI(SPARSE_AUG),
        "middlebury_Q": lambda: mod.Middlebury(SPARSE_AUG, split="Q"),
        "concat": lambda: mod.SceneFlowDatasets(AUG) * 2 + mod.KITTI(SPARSE_AUG),
    }


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tree")
    ft.build_sceneflow(str(root), n_train=5)
    ft.build_monkaa(str(root))
    ft.build_driving(str(root))
    ft.build_sintel(str(root))
    ft.build_falling_things(str(root))
    ft.build_tartanair(str(root))
    ft.build_kitti(str(root))
    ft.build_middlebury(str(root))
    return root


@pytest.mark.parametrize("name", list(_train_sets(datasets)))
def test_training_datasets_match_jax(tree, monkeypatch, name):
    monkeypatch.chdir(tree)
    ds, jd = _train_sets(datasets)[name](), _train_sets(jds)[name]()
    assert len(ds) == len(jd) > 0
    assert ds.image_list == jd.image_list and ds.disparity_list == jd.disparity_list
    for i in range(len(ds)):
        r1, r2 = np.random.default_rng(i), np.random.default_rng(i)
        got, want = ds.__getitem__(i, r1), jd.__getitem__(i, r2)
        assert _rng_state(r1) == _rng_state(r2)
        assert got[0].shape == (32, 48, 3) and got[0].dtype == want[0].dtype == np.float32
        assert _close_images(got[0], want[0]) and _close_images(got[1], want[1])
        assert _close_flow(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


# ------------------------------------------------------------------- loader


class _Args:
    train_datasets = ("sceneflow",)
    image_size = (32, 48)
    spatial_scale = (-0.2, 0.4)
    saturation_range = (0.0, 1.4)
    batch_size = 2
    noyjitter = False


def _loaders(tree, monkeypatch):
    monkeypatch.chdir(tree)
    ours, theirs = datasets.fetch_dataloader(_Args()), jds.fetch_dataloader(_Args())
    ours.num_workers = theirs.num_workers = 2
    return ours, theirs


def _take(stream, n):
    return [next(stream) for _ in range(n)]


def _assert_batches_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"img1", "img2", "flow", "valid"}
        assert _close_images(a["img1"], b["img1"]) and _close_images(a["img2"], b["img2"])
        assert _close_flow(a["flow"], b["flow"])
        np.testing.assert_array_equal(a["valid"], b["valid"])


def test_prefetch_loader_matches_jax_and_fast_forwards(tree, monkeypatch):
    ours, theirs = _loaders(tree, monkeypatch)
    assert len(ours) == len(theirs) == 2  # 5 pairs, batch 2, drop_last
    full = _take(ours.stream(0), 5)  # across epoch boundaries
    _assert_batches_match(full, _take(theirs.stream(0), 5))
    # fast-forward by index: the same batches as the uninterrupted stream
    resumed = _take(ours.stream(3), 2)
    _assert_batches_match(resumed, full[3:])
    for a, b in zip(resumed, full[3:]):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_prefetch_loader_quarantines_like_jax(tree, monkeypatch):
    bad = str(tree / "datasets/FlyingThings3D/disparity/TRAIN/A/0000/left/0001.pfm")
    monkeypatch.setattr(datasets.frame_io, "read_gen",
                        _failing(datasets.frame_io.read_gen, bad))
    monkeypatch.setattr(jds.frame_io, "read_gen", _failing(jds.frame_io.read_gen, bad))
    ours, theirs = _loaders(tree, monkeypatch)
    assert ours.dataset.disparity_list[1] == "datasets" + bad.split("datasets", 1)[1]
    got, want = _take(ours.stream(0), 2), _take(theirs.stream(0), 2)
    _assert_batches_match(got, want)
    assert ours.quarantined == theirs.quarantined == {1}
    # a systemic failure (every read fails) surfaces instead of looping
    monkeypatch.setattr(datasets.frame_io, "read_gen", _failing(lambda p: None, None))
    fresh = datasets.fetch_dataloader(_Args())
    fresh.num_workers = 2
    with pytest.raises(Exception):
        _take(fresh.stream(0), 1)


def _failing(read, bad_path):
    def reader(path, *a, **k):
        if bad_path is None or bad_path.endswith(path):
            raise OSError(f"unreadable {path}")
        return read(path, *a, **k)

    return reader
