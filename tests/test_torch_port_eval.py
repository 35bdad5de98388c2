"""The port's evaluation path on the CPU, against the JAX package's: the frame
readers (``data/frame_io.py``), the evaluation datasets
(``data/datasets.py``) and the four validators with the CLI
(``evaluate.py``), on the synthetic trees of ``tests/fixture_trees.py``.

The validators run on the same carried weights (``state_dict_from_jax``)
through the port's engine and its per-image path, each held to the JAX
validator's per-image metrics. The JAX package pins its own engine to its
per-image path bit for bit (tests/test_infer_engine.py); its per-image
forward is compiled once here, for every validator.
"""

import os
import os.path as osp

import fixture_trees as ft
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raft_stereo_tpu import evaluate as jax_evaluate
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.data import datasets as jax_datasets
from raft_stereo_tpu.data import frame_io as jax_frame_io
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.data import datasets, frame_io
from raft_stereo_tpu_torch.runtime import infer
from raft_stereo_tpu_torch.runtime.infer import InferOptions
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

JAX_CFG = JaxConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
                    corr_implementation="alt")
PORT_CFG = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                            corr_radius=2, corr_implementation="alt")
ITERS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_scene(base, scene, shape, disp, seed):
    """An ETH3D scene of another shape: a second bucket and a partial batch."""
    rng = np.random.RandomState(seed)
    d = osp.join(base, "two_view_training", scene)
    os.makedirs(d, exist_ok=True)
    for name in ("im0.png", "im1.png"):
        Image.fromarray(rng.randint(0, 255, shape + (3,), np.uint8)).save(osp.join(d, name))
    gt = osp.join(base, "two_view_training_gt", scene)
    os.makedirs(gt, exist_ok=True)
    frame_io.write_pfm(osp.join(gt, "disp0GT.pfm"), np.full(shape, disp, np.float32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trees"))
    ft.build_eth3d(root)
    _write_scene(osp.join(root, "datasets", "ETH3D"), "forest_1s", (56, 88), 5.0, seed=7)
    ft.build_kitti(root)
    ft.build_sceneflow(root, n_train=1, n_test=450)  # glob-only: the 400 of 450 split
    ft.build_middlebury(root)
    ft.build_middlebury_2014(root)
    things = str(tmp_path_factory.mktemp("things"))
    ft.build_sceneflow_test_readable(things, n=3)
    return root, things


# ------------------------------------------------------------------ frame_io


def test_readers_match_jax(trees, tmp_path):
    root, _ = trees
    base = osp.join(root, "datasets")
    pfm = osp.join(base, "ETH3D", "two_view_training_gt", "forest_1s", "disp0GT.pfm")
    np.testing.assert_array_equal(frame_io.read_pfm(pfm), jax_frame_io.read_pfm(pfm))
    np.testing.assert_array_equal(frame_io.read_gen(pfm), jax_frame_io.read_gen(pfm))
    png = osp.join(base, "KITTI", "training", "disp_occ_0", "000001_10.png")
    for got, want in zip(frame_io.read_disp_kitti(png), jax_frame_io.read_disp_kitti(png)):
        np.testing.assert_array_equal(got, want)
    mb = osp.join(base, "Middlebury", "MiddEval3", "trainingH", "chess1", "disp0GT.pfm")
    mb14 = osp.join(base, "Middlebury", "2014", "Pipes-perfect", "disp0.pfm")
    for path in (mb, mb14):
        for got, want in zip(frame_io.read_disp_middlebury(path),
                             jax_frame_io.read_disp_middlebury(path)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    img = osp.join(base, "KITTI", "training", "image_2", "000000_10.png")
    np.testing.assert_array_equal(np.asarray(frame_io.read_gen(img)),
                                  np.asarray(jax_frame_io.read_gen(img)))
    # the writers, read back by the JAX readers
    rng = np.random.RandomState(0)
    disp = (rng.rand(7, 9) * 100).astype(np.float32)
    frame_io.write_pfm(str(tmp_path / "d.pfm"), disp)
    np.testing.assert_array_equal(jax_frame_io.read_pfm(str(tmp_path / "d.pfm")), disp)
    frame_io.write_disp_kitti(str(tmp_path / "d.png"), disp)
    got, valid = jax_frame_io.read_disp_kitti(str(tmp_path / "d.png"))
    np.testing.assert_array_equal(got, np.round(disp * 256) / 256)
    assert valid.all()
    with pytest.raises(ValueError):
        frame_io.write_pfm(str(tmp_path / "c.pfm"), np.zeros((2, 2, 3), np.float32))


def test_io_retry_heals_a_transient_error_and_fails_fast_on_a_missing_file(monkeypatch):
    monkeypatch.setattr(frame_io, "IO_BACKOFF_S", 0.0)
    calls = []

    @frame_io.with_io_retry
    def flaky(path):
        calls.append(path)
        if len(calls) < 3:
            raise OSError("stale handle")
        return "ok"

    assert flaky("p") == "ok" and len(calls) == 3
    calls.clear()
    with pytest.raises(FileNotFoundError):
        frame_io.read_pfm("/nonexistent/disp0GT.pfm")

    @frame_io.with_io_retry
    def dead(path):
        calls.append(path)
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        dead("q")
    assert len(calls) == frame_io.IO_RETRIES + 1


# ------------------------------------------------------------------ datasets


def _eval_sets(mod, things_root):
    return {
        "eth3d": lambda: mod.ETH3D(aug_params=None),
        "kitti": lambda: mod.KITTI(aug_params=None),
        "middlebury_F": lambda: mod.Middlebury(aug_params=None, split="F"),
        "middlebury_Q": lambda: mod.Middlebury(aug_params=None, split="Q"),
        "middlebury_2014": lambda: mod.Middlebury(aug_params=None, split="2014"),
        "things_test_split": lambda: mod.SceneFlowDatasets(things_test=True),
        "things_readable": lambda: mod.SceneFlowDatasets(
            root=osp.join(things_root, "datasets"), things_test=True),
    }


@pytest.mark.parametrize("name", ["eth3d", "kitti", "middlebury_F", "middlebury_Q",
                                  "middlebury_2014", "things_test_split", "things_readable"])
def test_datasets_match_jax(trees, monkeypatch, name):
    root, things = trees
    monkeypatch.chdir(root)
    ds = _eval_sets(datasets, things)[name]()
    jds = _eval_sets(jax_datasets, things)[name]()
    assert len(ds) == len(jds) > 0
    assert ds.image_list == jds.image_list and ds.disparity_list == jds.disparity_list
    if name == "things_test_split":
        assert len(ds) == 400  # glob-only files: the split, nothing to read
        return
    for i in range(len(ds)):
        for got, want in zip(ds[i], jds.__getitem__(i)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_datasets_refuse_what_waits_for_training(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError):
        datasets.ETH3D(aug_params={"crop_size": (32, 64)})
    with pytest.raises(ValueError):
        datasets.Middlebury(split="X")
    # the augmentation-free SceneFlow TRAIN split serves online adaptation
    # (train_mad --adapt), as the JAX package's does
    ft.build_sceneflow(str(tmp_path), n_train=2)
    monkeypatch.chdir(tmp_path)
    ds, jds = datasets.SceneFlowDatasets(), jax_datasets.SceneFlowDatasets()
    assert ds.augmentor is None and ds.image_list == jds.image_list and len(ds) == 2
    for got, want in zip(ds[1], jds.__getitem__(1)):
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- validators


@pytest.fixture(scope="module")
def models():
    jmodel = JaxRAFTStereo(JAX_CFG)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(0))
    model = evaluate.load_model(PORT_CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


_JAX_MAKE_FORWARD = jax_evaluate.make_forward
_JAX_FORWARDS = {}


def _jax_make_forward_once(model, variables, iters):
    """The JAX per-image forward, jitted once for every validator (its
    ``make_forward`` jits a new closure per call)."""
    key = (id(model), id(variables), iters)
    if key not in _JAX_FORWARDS:
        _JAX_FORWARDS[key] = _JAX_MAKE_FORWARD(model, variables, iters)
    return _JAX_FORWARDS[key]


VALIDATORS = ["eth3d", "kitti", "things", "middlebury_F"]
# Tolerances, fp32 on the CPU at 2 iterations. Per pixel the two forwards
# agree to 5e-3 px (tests/test_torch_port_slice.py), so an EPE mean moves by
# at most that (measured: at most 1.1e-5 px over the four validators and
# both paths); a bad-pixel share moves only where a pixel's error lies
# within 5e-3 of the threshold, none of the fixture's at these seeds, so
# the D1 figures agree to float rounding (measured: equal).
EPE_ATOL = 5e-3
D1_ATOL = 1e-6


@pytest.mark.parametrize("name", VALIDATORS)
def test_validators_match_jax_on_both_paths(trees, models, monkeypatch, name):
    root, things = trees
    jmodel, variables, model = models
    monkeypatch.chdir(things if name == "things" else root)
    monkeypatch.setattr(jax_evaluate, "make_forward", _jax_make_forward_once)
    want = jax_evaluate.VALIDATORS[name](jmodel, variables, iters=ITERS, infer=None)
    infer.reset_summary()
    engine = evaluate.VALIDATORS[name](model, iters=ITERS, infer=InferOptions(batch=2))
    summary = infer.last_summary()
    assert summary is not None and summary.failed == 0 and summary.completed > 0
    per_image = evaluate.VALIDATORS[name](model, iters=ITERS, infer=None)
    for got in (engine, per_image):
        assert sorted(k for k in got if not k.endswith("fps")) == \
            sorted(k for k in want if not k.endswith("fps"))
        for k, v in want.items():
            if k.endswith("fps"):
                continue
            tol = EPE_ATOL if k.endswith("epe") else D1_ATOL
            assert np.isfinite(got[k]) and abs(got[k] - v) <= tol, (k, got[k], v)
    assert engine["kitti-fps"] > 0 if name == "kitti" else "kitti-fps" not in engine


def test_evaluate_cli_runs_both_paths(trees, monkeypatch):
    """``python -m raft_stereo_tpu_torch.evaluate --dataset eth3d``, on the
    CPU: the engine and the per-image path give the same metrics on the
    same model (one forward, at one batch, on one device)."""
    root, _ = trees
    monkeypatch.chdir(root)
    argv = ["--dataset", "eth3d", "--hidden_dims", "32", "32", "32", "--n_gru_layers", "1",
            "--corr_levels", "2", "--corr_radius", "2", "--corr_implementation", "alt",
            "--valid_iters", "2", "--infer_batch", "1"]
    engine = evaluate.main(argv, device="cpu")
    assert infer.last_summary().completed == 3
    per_image = evaluate.main(argv + ["--per_image"], device="cpu")
    assert infer.last_summary() is None  # the per-image path publishes nothing
    assert engine == per_image
