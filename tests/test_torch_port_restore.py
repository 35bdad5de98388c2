"""Two results where the port now agrees with the JAX package: ``.flo``
flow files (``data/frame_io.py``) and the inference CLIs' checkpoints.

* A ``.flo`` written by either package's ``write_flo`` reads equal in the
  other's ``read_gen`` (bitwise: both are little-endian float32 files); a
  bad magic raises ``ValueError``, a transient read error is retried.
* ``restore_weights`` (``evaluate.load_model``'s ``restore_ckpt``,
  ``evaluate_mad.load_mad_weights``, so ``--restore_ckpt``, ``--fast_ckpt``
  and ``--quality_ckpt``) reads the npz that the JAX package's
  ``save_train_state_npz(path, variables)`` writes. Loaded into the port,
  the variables give the JAX forward's output within the fp32 tolerances
  of ``tests/test_torch_port_slice.py`` (RAFT-Stereo: atol 2e-3 at low
  resolution, 5e-3 upsampled, rtol 1e-4) and
  ``tests/test_torch_port_madnet2.py`` (MADNet2: 1e-4 of the largest
  |disparity| plus 1e-6); ``evaluate --restore_ckpt`` on the npz gives the
  JAX validator's metrics within ``tests/test_torch_port_eval.py``'s
  (EPE 5e-3 px, D1 1e-6). A key the port cannot place raises, and an orbax
  directory is refused.
"""

import fixture_trees as ft
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import evaluate as jax_evaluate
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.data import frame_io as jax_frame_io
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.models import madnet2 as jmad
from raft_stereo_tpu.utils.checkpoints import save_train_state_npz
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.data import frame_io
from raft_stereo_tpu_torch.evaluate_mad import load_mad_weights
from raft_stereo_tpu_torch.models import madnet2
from raft_stereo_tpu_torch.runtime import faultinject
from raft_stereo_tpu_torch.utils.checkpoints import restore_weights

JAX_CFG = JaxConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
                    corr_implementation="alt")
PORT_CFG = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                            corr_radius=2, corr_implementation="alt")
ITERS = 2
H, W = 64, 128
LOW_ATOL, UP_ATOL, RTOL = 2e-3, 5e-3, 1e-4
MAD_RTOL, MAD_ATOL = 1e-4, 1e-6
EPE_ATOL, D1_ATOL = 5e-3, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_faults():
    faultinject.reset()
    yield
    faultinject.reset()


# ---------------------------------------------------------------------- .flo


def _flow(seed=0, h=7, w=11):
    return (np.random.RandomState(seed).randn(h, w, 2) * 20).astype(np.float32)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flo_written_by_either_package_reads_equal_in_the_other(tmp_path, writer):
    flow = _flow(3)
    path = str(tmp_path / "f.flo")
    (jax_frame_io if writer == "jax" else frame_io).write_flo(path, flow)
    got = frame_io.read_gen(path)
    want = jax_frame_io.read_gen(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (7, 11, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(frame_io.read_flo(path), jax_frame_io.read_flo(path))


def test_flo_bad_magic_raises_and_a_transient_error_is_retried(tmp_path, monkeypatch):
    bad = str(tmp_path / "bad.flo")
    np.array([1.0, 2.0, 3.0], np.float32).tofile(bad)
    with pytest.raises(ValueError, match="bad .flo magic"):
        frame_io.read_gen(bad)
    with pytest.raises(ValueError, match="bad .flo magic"):
        jax_frame_io.read_gen(bad)
    with pytest.raises(ValueError):
        frame_io.write_flo(str(tmp_path / "x.flo"), np.zeros((3, 4, 3), np.float32))
    good = str(tmp_path / "good.flo")
    frame_io.write_flo(good, _flow(5))
    monkeypatch.setenv("RAFT_IO_BACKOFF", "0")
    faultinject.arm(io_fail_reads={1})
    np.testing.assert_array_equal(frame_io.read_gen(good), _flow(5))
    assert faultinject.io_read_attempts() == 2


# ------------------------------------------------------- npz variables


def _perturb(variables, seed):
    """Non-trivial norm scales, biases and statistics (an init has ones and
    zeros there)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        if name in ("bias", "mean"):
            return (0.05 * rng.randn(*x.shape)).astype(x.dtype)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def raft_npz(tmp_path_factory):
    jmodel = JaxRAFTStereo(JAX_CFG)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    variables = _perturb(jax.jit(lambda k: jmodel.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(0)), seed=1)
    path = str(tmp_path_factory.mktemp("ckpt") / "raft_vars.npz")
    save_train_state_npz(path, variables)
    return jmodel, variables, path


def _pair(seed, b=1, h=H, w=W):
    rng = np.random.RandomState(seed)
    return [(rng.rand(b, h, w, 3) * 255).astype(np.float32) for _ in range(2)]


def test_load_model_restores_a_jax_variables_npz(raft_npz):
    jmodel, variables, path = raft_npz
    img1, img2 = _pair(2)
    low_j, up_j = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=ITERS, test_mode=True))(
        variables, jnp.asarray(img1), jnp.asarray(img2))
    model = evaluate.load_model(PORT_CFG, device="cpu", seed=5, restore_ckpt=path)
    with torch.no_grad():
        low_t, up_t = model(torch.from_numpy(img1), torch.from_numpy(img2), iters=ITERS)
    assert np.isfinite(up_t.numpy()).all()
    np.testing.assert_allclose(low_t.numpy(), np.asarray(low_j), atol=LOW_ATOL, rtol=RTOL)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=UP_ATOL, rtol=RTOL)


def test_evaluate_restore_ckpt_reads_a_jax_variables_npz(raft_npz, tmp_path, monkeypatch):
    """``evaluate --dataset eth3d --restore_ckpt X.npz`` on the CPU: the JAX
    validator's metrics on the same variables."""
    jmodel, variables, path = raft_npz
    ft.build_eth3d(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    want = jax_evaluate.VALIDATORS["eth3d"](jmodel, variables, iters=ITERS, infer=None)
    argv = ["--dataset", "eth3d", "--hidden_dims", "32", "32", "32", "--n_gru_layers", "1",
            "--corr_levels", "2", "--corr_radius", "2", "--corr_implementation", "alt",
            "--valid_iters", str(ITERS), "--infer_batch", "1", "--restore_ckpt", path]
    got = evaluate.main(argv, device="cpu")
    assert sorted(k for k in got if not k.endswith("fps")) == \
        sorted(k for k in want if not k.endswith("fps"))
    for k, v in want.items():
        if k.endswith("fps"):
            continue
        tol = EPE_ATOL if k.endswith("epe") else D1_ATOL
        assert np.isfinite(got[k]) and abs(got[k] - v) <= tol, (k, got[k], v)


def test_load_mad_weights_restores_a_jax_variables_npz(tmp_path):
    a, b = _pair(4, b=2, h=128, w=128)
    jm = jmad.MADNet2()
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), a, b), seed=2)
    path = str(tmp_path / "mad_vars.npz")
    save_train_state_npz(path, variables)
    want = jax.jit(jm.apply)(variables, a, b)
    model = madnet2.make_madnet2(seed=7, device="cpu")
    load_mad_weights(model, path)
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= MAD_RTOL * float(np.abs(w).max()) + MAD_ATOL, err


def test_a_key_the_port_cannot_place_raises(raft_npz, tmp_path):
    _, variables, _ = raft_npz
    model = evaluate.load_model(PORT_CFG, device="cpu")
    # a leaf under a module the port does not have
    extra = dict(variables, params=dict(variables["params"],
                                        bogus={"kernel": np.zeros((3, 3, 2, 2), np.float32)}))
    path = str(tmp_path / "extra.npz")
    save_train_state_npz(path, extra)
    with pytest.raises(RuntimeError, match="bogus"):
        restore_weights(model, path)
    # a collection that is not a model's variables (a train state's step)
    path = str(tmp_path / "state.npz")
    save_train_state_npz(path, {"step": np.int32(3), **variables})
    with pytest.raises(ValueError, match="no place"):
        restore_weights(model, path)
    # an orbax directory (refused, as the trainer's restore refuses it)
    with pytest.raises(ValueError, match="orbax"):
        restore_weights(model, str(tmp_path))


def test_the_three_checkpoint_forms_load_the_same_weights(raft_npz, tmp_path):
    """A port checkpoint and a reference-style ``.pth`` of the npz's
    weights restore the same state as the npz itself."""
    from raft_stereo_tpu_torch.utils.checkpoints import save_train_state

    _, _, path = raft_npz
    want = evaluate.load_model(PORT_CFG, device="cpu", restore_ckpt=path).state_dict()
    save_train_state(str(tmp_path / "port"), {"model": want})
    pth = str(tmp_path / "ref.pth")
    torch.save({f"module.{k}": v for k, v in want.items()}, pth)
    for src in (str(tmp_path / "port"), pth):
        got = evaluate.load_model(PORT_CFG, device="cpu", seed=9, restore_ckpt=src).state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert (tmp_path / "port.pt").is_file()
