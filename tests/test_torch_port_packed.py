"""The packed encoder stage and its conv (K3) of the port against the JAX
package, on the CPU.

On CPU tensors the port's ``packed_conv3x3`` computes its plain version,
so these tests hold that plain version to the JAX package's Pallas kernel
run by the Pallas interpreter (``pallas_packed_conv._INTERPRET``, the JAX
package's own test hook) on the TPU's packed weight of the same conv; the
port's trunk with ``_ENABLE_PACKED`` to the JAX trunk with its flag and to
itself without it; the port's gate to the JAX package's; and the whole
forward of both presets whose geometry passes the gate. Inputs and weights
are made from numpy seeds and carried with ``state_dict_from_jax``.
Tolerances: tests/test_packed_encoder.py's (kernel 1e-4, trunk 2e-4 /
1e-4) and tests/test_torch_port_slice.py's (forward), or stated with
their measurement.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_stereo_tpu.experiments.packed_encoder as jpe
import raft_stereo_tpu.experiments.pallas_packed_conv as ppc
import raft_stereo_tpu.models.extractor as jext
from raft_stereo_tpu.config import PRESETS as JAX_PRESETS
from raft_stereo_tpu.experiments.packed_conv import pack_kernel_3x3
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.models.extractor import BasicEncoder as JaxBasicEncoder
from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.experiments import packed_conv, packed_encoder
from raft_stereo_tpu_torch.models import extractor
from raft_stereo_tpu_torch.models.extractor import BasicEncoder
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

LOW_ATOL, UP_ATOL, RTOL = 2e-3, 5e-3, 1e-4  # tests/test_torch_port_slice.py
TRUNK_ATOL, TRUNK_RTOL = 2e-4, 1e-4  # tests/test_packed_encoder.py
ITERS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted(monkeypatch):
    """Calls of the port's K3 wrapper (on the CPU it runs the plain
    version and launches nothing, so its LAUNCHES stays put)."""
    calls = []
    wrapped = packed_conv.packed_conv3x3

    def count(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(packed_conv, "packed_conv3x3", count)
    return calls


@pytest.fixture
def packed_on(monkeypatch):
    """Both packages' packed stage on; the JAX kernel through the Pallas
    interpreter."""
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", True)
    monkeypatch.setattr(jext, "_ENABLE_PACKED", True)
    monkeypatch.setattr(ppc, "_INTERPRET", True)


def _perturb(variables, seed):
    """Seeded norm statistics, scales and biases (as in
    tests/test_torch_port_slice.py), so every norm and bias matters."""
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


# ----------------------------------------------------------------- the conv


def _conv_case(prologue, seed, B=2, H=68, W2=8):
    """numpy xp [B, H, W2, 128], HWIO weight, and [B, 128] scale/shift:
    per-lane scales (the two parities differ) with a positive shift
    ("relu", relu on) or a shift of both signs ("affine", relu off)."""
    rng = np.random.RandomState(seed)
    xp = rng.randn(B, H, W2, 128).astype(np.float32)
    w = (rng.randn(3, 3, 64, 64) * np.sqrt(2.0 / 576)).astype(np.float32)
    scale = shift = None
    if prologue is not None:
        scale = (0.5 + rng.rand(B, 128)).astype(np.float32)
        shift = rng.rand(B, 128).astype(np.float32)
        shift = 0.1 + 0.5 * shift if prologue == "relu" else shift - 0.5
    return xp, w, scale, shift, prologue == "relu"


def _both_convs(prologue, dtype, seed):
    xp, w, scale, shift, relu = _conv_case(prologue, seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = ppc.packed_conv3x3_pallas(
        jnp.asarray(xp, jdt), pack_kernel_3x3(jnp.asarray(w)),
        None if scale is None else jnp.asarray(scale),
        None if shift is None else jnp.asarray(shift), relu)
    t = packed_conv.packed_conv3x3(
        torch.from_numpy(xp).to(dtype), torch.from_numpy(w).to(dtype),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), relu)
    return t.float().numpy(), np.asarray(j.astype(jnp.float32))


@pytest.mark.parametrize("prologue", [None, "relu", "affine"])
def test_plain_conv_matches_interpreted_kernel_fp32(monkeypatch, prologue):
    """Two row bands a batch element (band 34 at H=68), so the halo rows
    between bands and at the image edges are both exercised; the positive
    shift would show a prologue applied to the padding."""
    monkeypatch.setattr(ppc, "_INTERPRET", True)
    got, want = _both_convs(prologue, torch.float32, seed=1)
    assert got.shape == (2, 68, 8, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("prologue", [None, "relu", "affine"])
def test_plain_conv_matches_interpreted_kernel_bf16(monkeypatch, prologue):
    """Both sum bf16 products in fp32 and round the output once; the sums
    run in another order, and XLA on the CPU may keep the prologue's
    x·scale in fp32 up to the add where the port rounds it. Measured on
    the CPU over seeds 2 and 3 and all three prologues: at most 0.0156
    (half a bf16 ulp at the largest |output|, 5.8-7.7), and at most 0.014%
    of the elements differ at all. Bounds: one ulp at the largest |output|,
    0.1% of the elements."""
    monkeypatch.setattr(ppc, "_INTERPRET", True)
    got, want = _both_convs(prologue, torch.bfloat16, seed=2)
    diff = np.abs(got - want)
    ulp = np.exp2(np.frexp(np.abs(want).max())[1] - 8.0)
    assert diff.max() <= ulp, (float(diff.max()), float(ulp))
    assert (diff > 0).mean() <= 1e-3, float((diff > 0).mean())


def test_plain_conv_pads_after_the_prologue():
    """conv(pad0(prologue(x))): with x = 0 and a positive shift the
    prologue gives a constant image, whose conv falls off at the border
    exactly as the padding's zeros say."""
    x = torch.zeros(1, 5, 3, 128)
    w = torch.ones(3, 3, 64, 64)
    shift = torch.full((1, 64), 0.5)
    out = packed_conv.packed_conv3x3(x, w, torch.ones(1, 64), shift, relu_prologue=True)
    out = packed_conv.unpack_x(out)[0, :, :, 0]  # [H, W] of one channel
    taps = torch.tensor([2.0, 3.0, 3.0, 3.0, 2.0])  # taps inside the image, per axis
    want = 64 * 0.5 * taps[:, None] * torch.tensor([2.0, 3.0, 3.0, 3.0, 3.0, 2.0])[None]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_prologue_lanes_follow_the_column_parity():
    """scale/shift [B, 128]: lanes 0-63 act on even columns, 64-127 on odd
    ones; [B, 64] applies to both."""
    rng = np.random.RandomState(3)
    xp = torch.from_numpy(rng.randn(1, 4, 6, 128).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32))
    s64 = torch.from_numpy((0.5 + rng.rand(1, 64)).astype(np.float32))
    t64 = torch.from_numpy(rng.randn(1, 64).astype(np.float32))
    both = packed_conv.packed_conv3x3(xp, w, s64, t64, True)
    tiled = packed_conv.packed_conv3x3(xp, w, s64.repeat(1, 2), t64.repeat(1, 2), True)
    torch.testing.assert_close(both, tiled, rtol=0, atol=0)
    odd_only = packed_conv.packed_conv3x3(
        xp, w, torch.cat([torch.ones(1, 64), s64], 1), torch.cat([torch.zeros(1, 64), t64], 1))
    x = packed_conv.unpack_x(xp).clone()
    x[:, :, 1::2] = x[:, :, 1::2] * s64[:, None, None] + t64[:, None, None]
    torch.testing.assert_close(odd_only, packed_conv.packed_conv3x3(packed_conv.pack_x(x), w),
                               rtol=0, atol=0)


@pytest.mark.parametrize(
    "make,err",
    [
        (lambda xp, w: (xp[..., :96], w, None, None, False), ValueError),  # C = 48
        (lambda xp, w: (xp.double(), w, None, None, False), TypeError),
        (lambda xp, w: (xp, w[:, :, :32], None, None, False), ValueError),
        (lambda xp, w: (xp, w.permute(3, 2, 0, 1), None, None, False), ValueError),  # OIHW
        (lambda xp, w: (xp, w.bfloat16(), None, None, False), TypeError),
        (lambda xp, w: (xp, w, None, None, True), ValueError),  # relu without affine
        (lambda xp, w: (xp, w, torch.ones(1, 64), None, False), ValueError),
        (lambda xp, w: (xp, w, torch.ones(1, 96), torch.ones(1, 96), False), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(make, err):
    xp, w = torch.zeros(1, 4, 8, 128), torch.zeros(3, 3, 64, 64)
    with pytest.raises(err):
        packed_conv.packed_conv3x3(*make(xp, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_weight_is_the_torch_conv(dtype):
    """A torch [64, 64, 3, 3] weight through pack_weight gives the conv
    that F.conv2d computes with it (fp32 sums of the dtype's values)."""
    rng = np.random.RandomState(9)
    w = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 64, 6, 10).astype(np.float32)).to(dtype)
    taps = packed_conv.pack_weight(w, dtype)
    assert taps.shape == (3, 3, 64, 64) and taps.dtype == dtype and taps.is_contiguous()
    xp = packed_conv.pack_x(x.permute(0, 2, 3, 1).contiguous())
    got = packed_conv.unpack_x(packed_conv.packed_conv3x3(xp, taps)).permute(0, 3, 1, 2)
    xn = x.float().contiguous(memory_format=torch.channels_last)  # the plain version's layout
    want = torch.nn.functional.conv2d(xn, w.to(dtype).float(), padding=1).to(dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pack_is_a_view_and_refuses_odd_width():
    x = torch.randn(2, 64, 6, 10).contiguous(memory_format=torch.channels_last)
    xp = packed_conv.pack_x(x.permute(0, 2, 3, 1))
    assert xp.shape == (2, 6, 5, 128) and xp.data_ptr() == x.data_ptr()
    torch.testing.assert_close(packed_conv.unpack_x(xp).permute(0, 3, 1, 2), x)
    with pytest.raises(ValueError, match="even"):
        packed_conv.pack_x(torch.zeros(1, 4, 7, 64))


# ---------------------------------------------------------------- the trunk


@functools.lru_cache(maxsize=None)
def _encoder_variables(norm_fn, downsample):
    enc = JaxBasicEncoder(output_dim=32, norm_fn=norm_fn, downsample=downsample)
    img = jnp.zeros((2, 32, 64, 3), jnp.float32)
    return _perturb(jax.jit(enc.init)(jax.random.PRNGKey(0), img), seed=4)


TRUNK_CASES = [("instance", 2), ("batch", 3), ("none", 3)]  # test_packed_encoder.py's + none


def _trunk_img():
    return (np.random.RandomState(5).rand(2, 32, 64, 3) * 2 - 1).astype(np.float32)


def _port_encoder(norm_fn, downsample):
    enc = BasicEncoder(output_dim=32, norm_fn=norm_fn, downsample=downsample).eval()
    enc.load_state_dict(state_dict_from_jax(_encoder_variables(norm_fn, downsample)),
                        strict=True)
    return enc


def _port_run(enc, img):
    with torch.no_grad():
        return enc(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("norm_fn,downsample", TRUNK_CASES)
def test_packed_trunk_matches_jax_packed_trunk(packed_on, counted, norm_fn, downsample):
    img = _trunk_img()
    enc = JaxBasicEncoder(output_dim=32, norm_fn=norm_fn, downsample=downsample)
    want = np.asarray(enc.apply(_encoder_variables(norm_fn, downsample), jnp.asarray(img)))
    got = _port_run(_port_encoder(norm_fn, downsample), img)
    assert len(counted) == 4  # layer1's convs, on the stacked batch
    np.testing.assert_allclose(got, want, atol=TRUNK_ATOL, rtol=TRUNK_RTOL)


@pytest.mark.parametrize("norm_fn,downsample", TRUNK_CASES)
def test_packed_trunk_matches_stock_trunk(monkeypatch, counted, norm_fn, downsample):
    img = _trunk_img()
    enc = _port_encoder(norm_fn, downsample)
    stock = _port_run(enc, img)
    assert counted == []
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", True)
    packed = _port_run(enc, img)
    stride = 1 + (downsample > 2)
    assert counted == [(2, 32 // stride, 64 // (2 * stride), 128)] * 4
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", False)
    assert _port_run(enc, img).tobytes() == stock.tobytes()
    assert len(counted) == 4
    np.testing.assert_allclose(packed, stock, atol=TRUNK_ATOL, rtol=TRUNK_RTOL)
    # the parameters are the stock ones, whatever the flags
    assert set(enc.state_dict()) == set(BasicEncoder(32, norm_fn, downsample).state_dict())


@pytest.mark.parametrize("channels_last", [True, False])
def test_packed_stage_keeps_the_input_layout(monkeypatch, channels_last):
    """The stage hands layer2 the layout the stock stage would: the
    model's channels-last image views stay channels-last (no copy), an
    NCHW-contiguous input comes back NCHW-contiguous."""
    enc = BasicEncoder(output_dim=16, norm_fn="batch", downsample=3).eval()
    x = torch.from_numpy(np.random.RandomState(8).rand(2, 32, 64, 3).astype(np.float32))
    x = x.permute(0, 3, 1, 2)  # the model's own view: channels-last
    if not channels_last:
        x = x.contiguous()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    with torch.no_grad():
        stock = enc.trunk(x)
        monkeypatch.setattr(extractor, "_ENABLE_PACKED", True)
        stage = packed_encoder.packed_stage(enc, x)
    assert stock.is_contiguous(memory_format=fmt)
    assert stage.is_contiguous(memory_format=fmt)
    torch.testing.assert_close(stage, enc.layer1(enc.relu1(enc.norm1(enc.conv1(x)))),
                               atol=TRUNK_ATOL, rtol=TRUNK_RTOL)


class _Engaged(Exception):
    pass


def _jax_packs(monkeypatch, H, W, norm_fn, downsample) -> bool:
    """Whether the JAX trunk takes its packed stage at this geometry:
    its packed stem raises on first use (shapes are traced, not
    computed)."""
    def stem(*args, **kwargs):
        raise _Engaged

    monkeypatch.setattr(jext, "_ENABLE_PACKED", True)
    monkeypatch.setattr(jpe, "PackedStemConv", stem)
    enc = JaxBasicEncoder(output_dim=8, norm_fn=norm_fn, downsample=downsample)
    try:
        jax.eval_shape(lambda x: enc.init(jax.random.PRNGKey(0), x),
                       jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32))
    except _Engaged:
        return True
    return False


@pytest.mark.parametrize(
    "H,W,norm_fn,downsample",
    [
        (544, 960, "batch", 3),  # the realtime preset's demo geometry: packs
        (544, 960, "instance", 2),  # the middlebury preset's: layer1 too large
        (32, 64, "instance", 2),
        (32, 64, "group", 2),  # no packed norm
        (32, 62, "batch", 3),  # W not divisible by 4
        (30, 64, "batch", 3),  # H not divisible by 4
        (36, 64, "none", 3),  # band rule: choose_band(18, 16) = 2
        (1088, 480, "batch", 3),  # 544 x 120 packed positions, band 34
        (1104, 1120, "batch", 3),  # 552 x 280 > PACKED_LAYER1_MAX_M
    ],
)
def test_gate_engages_where_the_jax_gate_does(monkeypatch, H, W, norm_fn, downsample):
    x = torch.empty((1, 3, H, W), device="meta")
    port = packed_encoder.packable(x, norm_fn, 1 + (downsample > 2))
    assert port == _jax_packs(monkeypatch, H, W, norm_fn, downsample)


@pytest.mark.parametrize("norm_fn,W,engaged", [("instance", 64, True), ("group", 64, False),
                                               ("instance", 63, False)])
def test_unpackable_inputs_stay_stock(monkeypatch, counted, norm_fn, W, engaged):
    """Group norm and an odd width keep the stock stage: K3 is not called."""
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", True)
    enc = BasicEncoder(output_dim=16, norm_fn=norm_fn, downsample=2).eval()
    with torch.no_grad():
        out = enc(torch.from_numpy(np.random.RandomState(6).rand(1, 3, 32, W).astype(np.float32)))
    assert out.shape == (1, 16, 8, (W + 3) // 4)
    assert len(counted) == (4 if engaged else 0)


# -------------------------------------------------------------- the forward


@functools.lru_cache(maxsize=None)
def _model_variables(jcfg):
    model = JaxRAFTStereo(jcfg)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    init = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))
    return _perturb(init(jax.random.PRNGKey(0)), seed=1)


@pytest.mark.parametrize("preset,k3_calls", [("raftstereo-realtime", 4),
                                             ("raftstereo-middlebury", 8)])
def test_forward_with_packed_stage_matches_jax(packed_on, counted, preset, k3_calls):
    """fp32, 64x128: the realtime preset runs one packed trunk on the
    stacked pair (shared backbone), the middlebury one packs both the
    context and the feature encoder (its gate passes at this size)."""
    jcfg = dataclasses.replace(JAX_PRESETS[preset], mixed_precision=False)
    tcfg = dataclasses.replace(PRESETS[preset], mixed_precision=False)
    variables = _model_variables(jcfg)
    rng = np.random.RandomState(7)
    img1, img2 = [(rng.rand(1, 64, 128, 3) * 255).astype(np.float32) for _ in range(2)]
    model = JaxRAFTStereo(jcfg)
    apply = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=ITERS, test_mode=True))
    low_j, up_j = apply(variables, jnp.asarray(img1), jnp.asarray(img2))
    tmodel = load_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    low_t, up_t = tmodel(torch.from_numpy(img1), torch.from_numpy(img2), iters=ITERS)
    assert len(counted) == k3_calls
    assert np.isfinite(up_t.numpy()).all()
    np.testing.assert_allclose(low_t.numpy(), np.asarray(low_j), atol=LOW_ATOL, rtol=RTOL)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=UP_ATOL, rtol=RTOL)
