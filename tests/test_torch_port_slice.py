"""The whole slice: the port's test-mode forward against the JAX package's
``RAFTStereo.apply(test_mode=True)`` on carried weights, on the CPU.

Weights: a JAX init with seeded random norm statistics and biases,
carried over with ``state_dict_from_jax`` and loaded ``strict=True``.
Inputs: numpy-seeded 64x128 images. Tolerances are those of
tests/test_torch_parity.py:102-103 (atol 2e-3 lowres / 5e-3 upsampled)
for fp32; the bf16 case states its own, measured one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import PRESETS as JAX_PRESETS
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import PRESETS, RAFTStereoConfig
from raft_stereo_tpu_torch.evaluate import load_model, make_forward
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

H, W = 64, 128
ITERS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(variables, seed):
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


def _jax_variables(jcfg):
    # parameters depend on the architecture only: one init per architecture
    return _init(dataclasses.replace(jcfg, corr_implementation="alt", mixed_precision=False))


@functools.lru_cache(maxsize=None)
def _init(jcfg):
    model = JaxRAFTStereo(jcfg)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    init = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))
    return _perturb(init(jax.random.PRNGKey(0)), seed=1)


def _pair(seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, 3) * 255).astype(np.float32) for _ in range(2)]


def _run_both(preset, mixed_precision, iters=ITERS, seed=2):
    jcfg = dataclasses.replace(JAX_PRESETS[preset], mixed_precision=mixed_precision)
    tcfg = dataclasses.replace(PRESETS[preset], mixed_precision=mixed_precision)
    variables = _jax_variables(jcfg)
    img1, img2 = _pair(seed)
    model = JaxRAFTStereo(jcfg)
    apply = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=iters, test_mode=True))
    low_j, up_j = apply(variables, jnp.asarray(img1), jnp.asarray(img2))
    tmodel = load_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    low_t, up_t = tmodel(torch.from_numpy(img1), torch.from_numpy(img2), iters=iters)
    f = tcfg.downsample_factor
    assert low_t.shape == (1, H // f, W // f, 2) and up_t.shape == (1, H, W, 1)
    assert float(low_t[..., 1].abs().max()) == 0.0  # y = 0
    return low_t.numpy(), up_t.numpy(), np.asarray(low_j), np.asarray(up_j)


@pytest.mark.parametrize("preset", ["raftstereo-middlebury", "raftstereo-realtime", "raftstereo"])
def test_forward_matches_jax_fp32(preset):
    """The slice's alt path at both alt presets' architectures, and the
    default preset's reg path on the same architecture as the first."""
    low_t, up_t, low_j, up_j = _run_both(preset, mixed_precision=False)
    assert np.isfinite(up_t).all()
    np.testing.assert_allclose(low_t, low_j, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(up_t, up_j, atol=5e-3, rtol=1e-4)


def test_forward_matches_jax_bf16():
    """The preset as shipped: bf16 convs, fp32 lookup and flow state. The
    frameworks round bf16 at other places (conv epilogues, norm applies),
    and the random model amplifies it with each iteration, so this case
    runs one. Measured on the CPU: max |Δ| 1.26 px (1.0% of the largest
    |disparity|, 127 px), mean |Δ| 0.28 px (0.22%). Bounds: twice that."""
    low_t, up_t, low_j, up_j = _run_both("raftstereo-middlebury", mixed_precision=True,
                                         iters=1)
    scale = float(np.abs(up_j).max())
    diff = np.abs(up_t - up_j)
    assert np.isfinite(up_t).all()
    assert diff.max() <= 0.02 * scale, (diff.max(), scale)
    assert diff.mean() <= 0.005 * scale, (diff.mean(), scale)
    assert np.abs(low_t - low_j).max() <= 0.02 * scale


def test_forward_helper_and_flow_init():
    """``make_forward`` runs the same forward; ``flow_init`` seeds the
    x-flow state as the JAX model's does."""
    jcfg = dataclasses.replace(JAX_PRESETS["raftstereo-middlebury"], mixed_precision=False)
    tcfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False)
    variables = _jax_variables(jcfg)
    img1, img2 = _pair(5)
    init = np.random.RandomState(6).randn(1, H // 4, W // 4, 2).astype(np.float32) * 3
    model = JaxRAFTStereo(jcfg)
    apply = jax.jit(lambda v, a, b, f: model.apply(v, a, b, iters=1, flow_init=f,
                                                   test_mode=True))
    low_j, up_j = apply(variables, jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(init))
    tmodel = load_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    _, up_t = tmodel(torch.from_numpy(img1), torch.from_numpy(img2), iters=1,
                     flow_init=torch.from_numpy(init))
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=5e-3, rtol=1e-4)
    disp = make_forward(tmodel, 1)(img1, img2)
    _, up_direct = tmodel(torch.from_numpy(img1), torch.from_numpy(img2), iters=1)
    torch.testing.assert_close(disp, up_direct, rtol=0, atol=0)


def test_large_input_runs_fnet_one_image_at_a_time(monkeypatch):
    """Above TWO_CALL_FNET_PIXELS the fnet runs per image; instance norm is
    per sample, so the result is the batched one."""
    import raft_stereo_tpu_torch.models.raft_stereo as rs

    cfg = RAFTStereoConfig(corr_implementation="alt", corr_levels=2, corr_radius=2)
    model = load_model(cfg, device="cpu", seed=4)
    img1, img2 = (torch.from_numpy(x) for x in _pair(7))
    _, batched = model(img1, img2, iters=1)
    monkeypatch.setattr(rs, "TWO_CALL_FNET_PIXELS", 0)
    calls = []
    handle = model.fnet.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    _, split = model(img1, img2, iters=1)
    handle.remove()
    assert calls == [1, 1]
    torch.testing.assert_close(split, batched, rtol=1e-5, atol=1e-4)
