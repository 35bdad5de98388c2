"""The PyTorch port's modules against the JAX package's, on the CPU.

Each JAX module is initialised, its norm statistics and biases are set to
seeded random values (so every parameter matters), its variables are
carried over with ``state_dict_from_jax`` and loaded ``strict=True``, and
both run the same numpy inputs in fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.models import extractor as jext
from raft_stereo_tpu.models import layers as jlayers
from raft_stereo_tpu.models import update as jupdate
from raft_stereo_tpu_torch.models import extractor as text
from raft_stereo_tpu_torch.models import layers as tlayers
from raft_stereo_tpu_torch.models import update as tupdate
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

# fp32 convs on both sides: only summation order differs
ATOL = 1e-4
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


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


def _carry(jmod, tmod, *args, **kwargs):
    """Init ``jmod`` on ``args``, perturb, load into ``tmod`` strictly."""
    init = jax.jit(functools.partial(jmod.init, **kwargs))
    v = _perturb(init(jax.random.PRNGKey(0), *args))
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    return v, tmod.eval()


def _apply(jmod, v, *args, **kwargs):
    return jax.jit(functools.partial(jmod.apply, **kwargs))(v, *args)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got_nchw, want_nhwc, atol=ATOL):
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_nhwc), atol=atol, rtol=RTOL)


def _img(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["batch", "instance", "group"])
def test_norms(kind):
    x = _img(1, 2, 6, 9, 16) * 3 + 1
    jmod = jlayers.make_norm(kind, 16, name=None)
    tmod = tlayers.make_norm(kind, 16)
    if kind == "instance":
        want = jmod.apply({}, jnp.asarray(x))
    else:
        v, tmod = _carry(jmod, tmod, jnp.asarray(x))
        want = jmod.apply(v, jnp.asarray(x))
    _close(tmod(_nchw(x)), want, atol=1e-5)


def test_instance_norm_bf16_stats_in_fp32():
    x = _img(2, 1, 5, 7, 8) * 4 + 2
    want = jlayers.InstanceNorm().apply({}, jnp.asarray(x, jnp.bfloat16))
    got = tlayers.InstanceNorm()(_nchw(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # same fp32 statistics; the bf16 apply rounds once per op
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize(
    "cin,planes,norm,stride",
    [(64, 96, "batch", 2), (32, 32, "instance", 1), (32, 64, "group", 1), (16, 16, "none", 2)],
)
def test_residual_block(cin, planes, norm, stride):
    x = _img(3, 2, 8, 12, cin)
    jmod = jlayers.ResidualBlock(planes, norm, stride)
    tmod = tlayers.ResidualBlock(cin, planes, norm, stride)
    v, tmod = _carry(jmod, tmod, jnp.asarray(x))
    has_shortcut = not (stride == 1 and cin == planes)
    assert (tmod.downsample is not None) == has_shortcut
    _close(tmod(_nchw(x)), _apply(jmod, v, jnp.asarray(x)))


@pytest.mark.parametrize("downsample", [2, 3])
def test_basic_encoder(downsample):
    x = _img(4, 2, 32, 32, 3)
    jmod = jext.BasicEncoder(output_dim=256, norm_fn="instance", downsample=downsample)
    tmod = text.BasicEncoder(output_dim=256, norm_fn="instance", downsample=downsample)
    v, tmod = _carry(jmod, tmod, jnp.asarray(x))
    _close(tmod(_nchw(x)), _apply(jmod, v, jnp.asarray(x)))


@pytest.mark.parametrize("num_layers,dual", [(3, False), (2, True)])
def test_multi_basic_encoder(num_layers, dual):
    x = _img(5, 2, 32, 32, 3)
    dims = ((128, 128, 128), (128, 128, 128))
    jmod = jext.MultiBasicEncoder(output_dim=dims, norm_fn="batch", downsample=2)
    tmod = text.MultiBasicEncoder(output_dim=dims, norm_fn="batch", downsample=2,
                                  num_layers=num_layers)
    v, tmod = _carry(jmod, tmod, jnp.asarray(x), dual_inp=dual, num_layers=num_layers)
    want = _apply(jmod, v, jnp.asarray(x), dual_inp=dual, num_layers=num_layers)
    got = tmod(_nchw(x), dual_inp=dual)
    assert len(got) == len(want) == num_layers + dual
    for level in range(num_layers):
        for head in range(2):
            _close(got[level][head], want[level][head])
    if dual:
        _close(got[-1], want[-1])


def _update_inputs(n_layers, B=1, H=8, W=12, hd=128, seed=6):
    rng = np.random.RandomState(seed)
    shapes = [(H, W), (H // 2, W // 2), (H // 4, W // 4)][:n_layers]
    net = [np.tanh(rng.randn(B, h, w, hd)).astype(np.float32) for h, w in shapes]
    ctx = [[(0.5 * rng.randn(B, h, w, hd)).astype(np.float32) for _ in range(3)]
           for h, w in shapes]
    corr = rng.randn(B, H, W, 36).astype(np.float32)
    flow = (3 * rng.randn(B, H, W, 1)).astype(np.float32)
    return net, ctx, corr, flow


@pytest.mark.parametrize("n_layers", [3, 2, 1])
def test_update_block(n_layers):
    net, ctx, corr, flow = _update_inputs(n_layers)
    # the JAX block indexes a 3-entry net list for its cross-scale wiring
    jnet = tuple(jnp.asarray(n) for n in net)
    jctx = tuple(tuple(jnp.asarray(c) for c in lvl) for lvl in ctx)
    jmod = jupdate.BasicMultiUpdateBlock((128,) * 3, n_gru_layers=n_layers, n_downsample=2)
    kw = dict(iter32=n_layers == 3, iter16=n_layers >= 2)
    tmod = tupdate.BasicMultiUpdateBlock((128,) * 3, n_gru_layers=n_layers, n_downsample=2)
    v, tmod = _carry(jmod, tmod, jnet, jctx, jnp.asarray(corr), jnp.asarray(flow), **kw)
    jn, jmask, jdelta = _apply(jmod, v, jnet, jctx, jnp.asarray(corr), jnp.asarray(flow), **kw)
    tn, tmask, tdelta = tmod([_nchw(n) for n in net],
                             [tuple(_nchw(c) for c in lvl) for lvl in ctx],
                             _nchw(corr), _nchw(flow), **kw)
    for a, b in zip(tn, jn):
        _close(a, b)
    _close(tmask, jmask)
    _close(tdelta, jdelta)


def test_update_block_slow_fast_gru_only_steps():
    """The context-only (update=False) coarse steps of slow-fast scheduling."""
    net, ctx, corr, flow = _update_inputs(3, seed=7)
    jnet = tuple(jnp.asarray(n) for n in net)
    jctx = tuple(tuple(jnp.asarray(c) for c in lvl) for lvl in ctx)
    jmod = jupdate.BasicMultiUpdateBlock((128,) * 3, n_gru_layers=3, n_downsample=2)
    tmod = tupdate.BasicMultiUpdateBlock((128,) * 3, n_gru_layers=3, n_downsample=2)
    v, tmod = _carry(jmod, tmod, jnet, jctx, jnp.asarray(corr), jnp.asarray(flow))
    kw = dict(iter32=True, iter16=True, iter08=False, update=False)
    want = _apply(jmod, v, jnet, jctx, **kw)
    got = tmod([_nchw(n) for n in net], [tuple(_nchw(c) for c in lvl) for lvl in ctx], **kw)
    for a, b in zip(got, want):
        _close(a, b)


def test_motion_encoder_layout():
    """[126 conv, flow_x, 0]: the reference's [out, flow] with y = 0."""
    rng = np.random.RandomState(8)
    corr = rng.randn(1, 6, 10, 36).astype(np.float32)
    flow = rng.randn(1, 6, 10, 1).astype(np.float32)
    jmod = jupdate.BasicMotionEncoder()
    tmod = tupdate.BasicMotionEncoder(4, 4)
    v, tmod = _carry(jmod, tmod, jnp.asarray(flow), jnp.asarray(corr))
    (want,) = _apply(jmod, v, jnp.asarray(flow), jnp.asarray(corr))
    got = tmod(_nchw(flow), _nchw(corr))
    assert got.shape == (1, 128, 6, 10)
    torch.testing.assert_close(got[:, 126:127], _nchw(flow), rtol=0, atol=0)
    assert float(got[:, 127].abs().max()) == 0.0
    _close(got, want)
