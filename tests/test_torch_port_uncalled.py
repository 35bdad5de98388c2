"""The four symbols of the JAX package that no model calls, on the port,
against the JAX ones on the CPU: ``models/update.py::SepConvGRU``,
``models/layers.py::BottleneckBlock`` (its weights carried by
``state_dict_from_jax``, the shortcut norm as both ``norm4`` and
``downsample.1``), ``ops/sampling.py::upflow`` and ``gauss_blur``.

Modules are initialised in JAX, their norm statistics and biases set to
seeded random values, carried over and loaded ``strict=True``; both sides
run the same numpy inputs in fp32, where only summation order differs
(1e-4 absolute and relative, as ``tests/test_torch_port_modules.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.models import layers as jlayers
from raft_stereo_tpu.models import update as jupdate
from raft_stereo_tpu.ops import sampling as jsampling
from raft_stereo_tpu_torch.models import layers as tlayers
from raft_stereo_tpu_torch.models import update as tupdate
from raft_stereo_tpu_torch.ops import sampling as tsampling
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

ATOL = 1e-4
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(variables, seed=0):
    """Seeded non-trivial norm affines, running statistics and biases."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*x.shape)).astype(x.dtype)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _img(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got_nchw, want_nhwc):
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(), np.asarray(want_nhwc),
                               atol=ATOL, rtol=RTOL)


def _carry(jmod, tmod, *args):
    v = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v))
    tmod.load_state_dict(sd, strict=True)
    return v, tmod.eval(), sd


@pytest.mark.parametrize("cin,planes,norm,stride", [
    (32, 32, "group", 1), (32, 64, "group", 2), (16, 64, "batch", 2),
    (64, 64, "instance", 1), (16, 32, "none", 2),
])
def test_bottleneck_block(cin, planes, norm, stride):
    x = _img(3, 2, 8, 12, cin)
    jmod = jlayers.BottleneckBlock(planes, norm, stride)
    tmod = tlayers.BottleneckBlock(cin, planes, norm, stride)
    v, tmod, sd = _carry(jmod, tmod, jnp.asarray(x))
    if stride != 1 and norm in ("group", "batch"):
        # one norm, two names; the bottleneck's own norm3 is not it
        for leaf in ("weight", "bias"):
            assert torch.equal(sd[f"norm4.{leaf}"], sd[f"downsample.1.{leaf}"])
            assert not torch.equal(sd[f"norm3.{leaf}"], sd[f"downsample.1.{leaf}"])
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert got.shape[1] == planes
    _close(got, jax.jit(jmod.apply)(v, jnp.asarray(x)))


@pytest.mark.parametrize("hidden,parts", [(8, (5,)), (16, (7, 9))])
def test_sep_conv_gru(hidden, parts):
    h = np.tanh(_img(4, 2, 9, 13, hidden))
    xs = [_img(5 + i, 2, 9, 13, c) for i, c in enumerate(parts)]
    jmod = jupdate.SepConvGRU(hidden_dim=hidden)
    tmod = tupdate.SepConvGRU(hidden_dim=hidden, input_dim=sum(parts))
    v, tmod, _ = _carry(jmod, tmod, jnp.asarray(h), *map(jnp.asarray, xs))
    with torch.no_grad():
        got = tmod(_nchw(h), *map(_nchw, xs))
    _close(got, jax.jit(jmod.apply)(v, jnp.asarray(h), *map(jnp.asarray, xs)))


def test_sep_conv_gru_needs_an_input():
    with pytest.raises(ValueError, match="at least one input"):
        tupdate.SepConvGRU(hidden_dim=4, input_dim=4)(torch.zeros(1, 4, 3, 3))


@pytest.mark.parametrize("factor", [8, 4, 2])
def test_upflow(factor):
    flow = _img(6, 2, 5, 7, 2) * 3
    want = jax.jit(functools.partial(jsampling.upflow, factor=factor))(jnp.asarray(flow))
    got = tsampling.upflow(torch.from_numpy(flow), factor)
    assert got.shape == (2, 5 * factor, 7 * factor, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,std", [(5, 1.0), (3, 0.5), (7, 2.0)])
def test_gauss_blur(n, std):
    x = _img(7, 2, 9, 11, 3)
    want = jax.jit(functools.partial(jsampling.gauss_blur, N=n, std=std))(jnp.asarray(x))
    got = tsampling.gauss_blur(torch.from_numpy(x), n, std)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
