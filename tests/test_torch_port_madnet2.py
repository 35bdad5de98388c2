"""The MADNet2 family of the port (``models/madnet2.py``, ``attention.py``,
``madnet2_fusion.py``, ``ops/sampling.bilinear_upsample``) and its weight
bridge against the JAX package, on the CPU.

Inputs come from a numpy seed; the JAX package's weights are carried into
the port by ``state_dict_from_jax`` (strict). Shapes: B = 2 images of
128x256 (the smallest MADNet2 input is 128 on a side). Tolerances, each
stated where it is checked:

  * fp32 modules and forwards: max |Δ| <= 1e-4·max|JAX| + 1e-6 per output
    (the same arithmetic; convolutions summed in another order);
  * the bf16 forward: max |Δ| <= 4e-2·max|JAX| per level (both sides round
    every conv's output to bf16, 2^-8 relative, and the five levels feed
    each other; measured up to 1.6e-2);
  * losses: 1e-5 relative; gradients: 1e-4·max|JAX grad| + 1e-9 per tensor,
    and exactly zero wherever the MAD isolation puts JAX's at zero;
  * ``MADController``: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import losses as jlosses
from raft_stereo_tpu.models import attention as jatt
from raft_stereo_tpu.models import madnet2 as jmad
from raft_stereo_tpu.models import madnet2_fusion as jfus
from raft_stereo_tpu.ops import sampling as jsampling
from raft_stereo_tpu.ops.pad import InputPadder as JaxPadder
from raft_stereo_tpu.runtime.adapt import upsample_predictions as jax_upsample_predictions
from raft_stereo_tpu.train_mad import mad2_loss as jax_mad2_loss
from raft_stereo_tpu.utils.torch_import import convert_state_dict
from raft_stereo_tpu_torch.models import attention, madnet2, madnet2_fusion
from raft_stereo_tpu_torch.ops import sampling
from raft_stereo_tpu_torch.ops.pad import InputPadder
from raft_stereo_tpu_torch.runtime.adapt import upsample_predictions
from raft_stereo_tpu_torch.train_mad import mad2_loss
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

B, H, W = 2, 128, 256
FP32_RTOL, FP32_ATOL = 1e-4, 1e-6
BF16_RTOL = 4e-2
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-9


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed=0, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    return ((rng.rand(b, h, w, 3) * 255).astype(np.float32),
            (rng.rand(b, h, w, 3) * 255).astype(np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=FP32_RTOL, atol=FP32_ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, (what, err, np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------ modules


def test_feature_extraction_matches_jax():
    x = _images(1, h=64, w=128)[0] / 255.0
    jm = jmad.FeatureExtraction()
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), x)
    want = jax.jit(jm.apply)(v, x)
    m = madnet2.FeatureExtraction()
    m.load_state_dict(state_dict_from_jax(_np(v)), strict=True)
    with torch.no_grad():
        got = m(_nchw(x))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_nhwc(g), w, what=f"block{i}")


def _standalone_sd(v, sequential):
    """A standalone DisparityDecoder's or ContextNet's state_dict: the bridge
    maps a decoder's ``conv{j}`` inside MADNet2 (``decoder2.decoder.*``), so
    the tree is nested under ``decoder2`` and the prefix renamed."""
    sd = state_dict_from_jax({"params": {"decoder2": _np(v)["params"]}})
    return {sequential + k.removeprefix("decoder2.decoder"): t for k, t in sd.items()}


def test_disparity_decoder_matches_jax():
    x = np.random.RandomState(2).randn(2, 16, 32, 38).astype(np.float32)
    jm = jmad.DisparityDecoder()
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), x)
    m = madnet2.DisparityDecoder(38)
    m.load_state_dict(_standalone_sd(v, "decoder"), strict=True)
    with torch.no_grad():
        _close(_nhwc(m(_nchw(x))), jax.jit(jm.apply)(v, x))


def test_context_net_matches_jax():
    x = np.random.RandomState(3).randn(1, 40, 48, 33).astype(np.float32)
    jm = jmad.ContextNet()
    v = jax.jit(jm.init)(jax.random.PRNGKey(3), x)
    m = madnet2.ContextNet(33)
    m.load_state_dict(_standalone_sd(v, "context"), strict=True)
    with torch.no_grad():
        _close(_nhwc(m(_nchw(x))), jax.jit(jm.apply)(v, x))


def test_bilinear_upsample_matches_jax():
    x = np.random.RandomState(4).randn(2, 8, 12, 1).astype(np.float32)
    got = sampling.bilinear_upsample(torch.from_numpy(x), 4)
    _close(got, jsampling.bilinear_upsample(jnp.asarray(x), 4), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mad_vars():
    a, b = _images(0)
    jm = jmad.MADNet2()
    return _np(jax.jit(jm.init)(jax.random.PRNGKey(0), a[:1, :128, :128], b[:1, :128, :128]))


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "bf16"])
def test_madnet2_matches_jax(mad_vars, mixed):
    a, b = _images(5)
    want = jax.jit(jmad.MADNet2(mixed_precision=mixed).apply)(mad_vars, a, b)
    m = madnet2.MADNet2(mixed_precision=mixed)
    m.load_state_dict(state_dict_from_jax(mad_vars), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(a), torch.from_numpy(b))
        got_mad = m(torch.from_numpy(a), torch.from_numpy(b), mad=True)
    assert len(got) == 5
    for k, (g, w, gm) in enumerate(zip(got, want, got_mad)):
        assert g.dtype == torch.float32
        s = 4 * 2 ** k
        assert g.shape == (B, H // s, W // s, 1)
        if mixed:
            _close(g, w, rtol=BF16_RTOL, atol=0.0, what=f"disp{k + 2}")
        else:
            _close(g, w, what=f"disp{k + 2}")
        # the detaches change gradients only
        torch.testing.assert_close(gm, g, rtol=0, atol=0)


# ---------------------------------------------------------------- attention


def test_attention_with_pos_enc_matches_jax():
    C, E, Wd = 8, 2, 12
    rng = np.random.RandomState(6)
    q = rng.randn(2, 3, Wd, C).astype(np.float32)
    kv = rng.randn(2, 3, Wd, C).astype(np.float32)
    pos = rng.randn(2 * Wd - 1, C).astype(np.float32)
    jm = jatt.MultiheadAttentionRelative(C, E)
    v = jm.init(jax.random.PRNGKey(6), q, kv, pos_enc=pos)
    v = jax.tree_util.tree_map(lambda x: x + 0.1 * jnp.ones_like(x), v)  # non-zero biases
    want = jm.apply(v, q, kv, pos_enc=pos)
    m = attention.MultiheadAttentionRelative(C, E)
    m.load_state_dict(state_dict_from_jax(_np(v)), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(q), torch.from_numpy(kv), pos_enc=torch.from_numpy(pos))
    for g, w, what in zip(got, want, ("out", "attn", "raw_attn")):
        _close(g, w, what=what)


def test_cross_attn_layer_last_layer_matches_jax():
    C, Wd = 5, 10
    rng = np.random.RandomState(7)
    left = rng.randn(2, 4, Wd, C).astype(np.float32)
    right = rng.randn(2, 4, Wd, C).astype(np.float32)
    jm = jatt.TransformerCrossAttnLayer(C, 1)
    v = jm.init(jax.random.PRNGKey(7), left, right, last_layer=True)
    want_out, want_raw = jm.apply(v, left, right, last_layer=True)
    m = attention.TransformerCrossAttnLayer(C, 1)
    m.load_state_dict(state_dict_from_jax(_np(v)), strict=True)
    with torch.no_grad():
        out, raw = m(torch.from_numpy(left), torch.from_numpy(right), last_layer=True)
    _close(out, want_out, what="out")
    raw, want_raw = raw.numpy(), np.asarray(want_raw)
    # STTR's mask: query i attends keys j <= i only
    masked = np.triu(np.ones((Wd, Wd), bool), k=1)
    assert np.isneginf(raw[..., masked]).all() and np.isneginf(want_raw[..., masked]).all()
    _close(raw[..., ~masked], want_raw[..., ~masked], what="raw_attn")


# ------------------------------------------------------------------- fusion


def test_guidance_encoders_and_fusion_block_match_jax():
    g = (np.random.RandomState(8).rand(2, 64, 128, 1) * 30).astype(np.float32)
    jm = jfus.GuidanceEncoder()
    v = jax.jit(jm.init)(jax.random.PRNGKey(8), g)
    want = jax.jit(jm.apply)(v, g)
    m = madnet2_fusion.GuidanceEncoder()
    m.load_state_dict(state_dict_from_jax(_np(v)), strict=True)
    with torch.no_grad():
        got = m(_nchw(g))
    assert sorted(got) == sorted(want) == [2, 3, 4, 5, 6]
    for k in got:
        _close(_nhwc(got[k]), want[k], what=f"guide{k}")

    jm = jfus.GuidanceEncoderSmall()
    v = jax.jit(jm.init)(jax.random.PRNGKey(9), g)
    m = madnet2_fusion.GuidanceEncoderSmall()
    m.load_state_dict(state_dict_from_jax(_np(v)), strict=True)
    with torch.no_grad():
        _close(_nhwc(m(_nchw(g))), jax.jit(jm.apply)(v, g), what="small")

    x = np.random.RandomState(10).randn(1, 8, 8, 6).astype(np.float32)
    jm = jfus.FusionBlock(4)
    v = jm.init(jax.random.PRNGKey(10), x)
    m = madnet2_fusion.FusionBlock(6, 4)
    m.load_state_dict(state_dict_from_jax(_np(v)), strict=True)
    with torch.no_grad():
        _close(_nhwc(m(_nchw(x))), jm.apply(v, x), what="fusion_block")


def test_madnet2_fusion_matches_jax():
    a, b = _images(11)
    g = (np.random.RandomState(12).rand(B, H, W, 1) * 20).astype(np.float32)
    jm = jfus.MADNet2Fusion()
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(11), a[:1, :128, :128], b[:1, :128, :128],
                             g[:1, :128, :128]))
    want = jax.jit(jm.apply)(v, a, b, g)
    m = madnet2_fusion.MADNet2Fusion()
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(g))
    for k, (gt_, w) in enumerate(zip(got, want)):
        _close(gt_, w, what=f"disp{k + 2}")


# ------------------------------------------------------------------- losses


def _full_preds(seed, b=2, h=32, w=64):
    rng = np.random.RandomState(seed)
    return [(rng.rand(b, h, w, 1) * 12).astype(np.float32) for _ in range(5)]


@pytest.mark.parametrize("mode", ["full", "full++", "mad", "mad++"])
def test_adaptation_loss_matches_jax(mode):
    preds = _full_preds(13)
    rng = np.random.RandomState(14)
    img1, img2 = ((rng.rand(2, 32, 64, 3) * 255).astype(np.float32) for _ in range(2))
    gt = (rng.rand(2, 32, 64, 1) * 12).astype(np.float32)
    valid = (rng.rand(2, 32, 64) > 0.3).astype(np.float32)
    idx = 2
    want, want_per = jmad.adaptation_loss(img1, img2, preds, gt, valid, mode, idx)
    t = torch.from_numpy
    got, got_per = madnet2.adaptation_loss(t(img1), t(img2), [t(p) for p in preds], t(gt),
                                           t(valid), mode, idx)
    _close(got, want, rtol=LOSS_RTOL, atol=0.0)
    if mode in ("full", "full++"):
        _close(got_per, want_per, rtol=LOSS_RTOL, atol=0.0)
    else:
        assert got_per is None and want_per is None


def test_supervised_losses_match_jax():
    rng = np.random.RandomState(15)
    pyramid = [(rng.randn(2, 128 // s, 256 // s, 1)).astype(np.float32)
               for s in (4, 8, 16, 32, 64)]
    gt_full = (rng.rand(2, 128, 256, 1) * 40).astype(np.float32)
    t = torch.from_numpy
    _close(madnet2.training_loss([t(p) for p in pyramid], t(gt_full)),
           jmad.training_loss(pyramid, gt_full), rtol=LOSS_RTOL, atol=0.0)
    preds = _full_preds(16)
    img1, img2 = ((rng.rand(2, 32, 64, 3) * 255).astype(np.float32) for _ in range(2))
    gt = (rng.rand(2, 32, 64, 1) * 250).astype(np.float32)  # some past max_disp
    valid = (rng.rand(2, 32, 64) > 0.2).astype(np.float32)
    for port_fn, jax_fn in (
            (lambda *a: madnet2.compute_mad_loss(t(img1), t(img2), *a),
             lambda *a: jmad.compute_mad_loss(img1, img2, *a)),
            (mad2_loss, jax_mad2_loss)):
        loss, metrics = port_fn([t(p) for p in preds], t(gt), t(valid))
        jloss, jmetrics = jax_fn(preds, gt, valid)
        _close(loss, jloss, rtol=LOSS_RTOL, atol=0.0)
        assert sorted(metrics) == sorted(jmetrics)
        for k in metrics:
            _close(metrics[k], jmetrics[k], rtol=LOSS_RTOL, atol=1e-6, what=k)


def test_upsample_predictions_matches_jax():
    rng = np.random.RandomState(17)
    pyramid = [rng.randn(1, 128 // s, 256 // s, 1).astype(np.float32)
               for s in (4, 8, 16, 32, 64)]
    x = np.zeros((1, 100, 250, 3), np.float32)
    got = upsample_predictions([torch.from_numpy(p) for p in pyramid],
                               InputPadder(x.shape, divis_by=128))
    want = jax_upsample_predictions(pyramid, JaxPadder(x.shape, divis_by=128))
    for g, w in zip(got, want):
        assert g.shape == (1, 100, 250, 1)
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(w)), rtol=0, atol=0)


# ------------------------------------------------- gradient isolation (MAD)


@pytest.mark.parametrize("idx", [0, 3])
def test_mad_gradients_isolate_the_sampled_block_and_match_jax(mad_vars, idx):
    """``adaptation_loss('mad', idx)`` through the ``mad=True`` forward:
    the gradient reaches block idx + 2 of the pyramid and its decoder and
    nothing else, and equals ``jax.grad``'s."""
    a, b = _images(18, h=100, w=250)  # padded to 128x256 inside
    jm = jmad.MADNet2()

    def jloss(params):
        padder = JaxPadder(a.shape, divis_by=128)
        i1, i2 = padder.pad(jnp.asarray(a), jnp.asarray(b))
        full = jax_upsample_predictions(jm.apply({"params": params}, i1, i2, mad=True), padder)
        return jmad.adaptation_loss(a, b, full, None, None, "mad", idx)[0]

    jgrads = state_dict_from_jax({"params": _np(jax.jit(jax.grad(jloss))(mad_vars["params"]))})
    m = madnet2.MADNet2()
    m.load_state_dict(state_dict_from_jax(mad_vars), strict=True)
    padder = InputPadder(a.shape, divis_by=128)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    i1, i2 = padder.pad(ta, tb)
    full = upsample_predictions(m(i1, i2, mad=True), padder)
    madnet2.adaptation_loss(ta, tb, full, None, None, "mad", idx)[0].backward()
    level = idx + 2
    owners = (f"feature_extraction.block{level}.", f"decoder{level}.")
    reached = {n for n, p in m.named_parameters()
               if p.grad is not None and bool(p.grad.abs().sum() > 0)}
    assert reached and all(n.startswith(owners) for n in reached), sorted(reached)
    assert {n for n, _ in m.named_parameters() if n.startswith(owners)} == reached
    for n, p in m.named_parameters():
        want = jgrads[n].numpy()
        if n in reached:
            _close(p.grad, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, what=n)
        else:
            assert not np.any(want), n  # JAX's isolation agrees


# --------------------------------------------------------------- controller


def test_mad_controller_is_bitwise_the_jax_one():
    port, ref = madnet2.MADController(seed=5), jmad.MADController(seed=5)
    rng = np.random.RandomState(19)
    for step in range(40):
        blocks = (port.sample_block(), ref.sample_block())
        assert blocks[0] == blocks[1]
        loss = float(rng.rand() * 3)
        port.update_sample_distribution(blocks[0], loss)
        ref.update_sample_distribution(blocks[1], loss)
        if step % 7 == 6:
            assert port.get_block_to_send() == ref.get_block_to_send()
        assert port.sample_all() == ref.sample_all() == -1
        for name in ("sample_distribution", "updates_histogram", "accumulated_loss"):
            assert getattr(port, name).tobytes() == getattr(ref, name).tobytes(), name
        assert (port.loss_t1, port.loss_t2) == (ref.loss_t1, ref.loss_t2)


# -------------------------------------------------------------- weight bridge


@pytest.mark.parametrize("fusion", [False, True], ids=["madnet2", "fusion"])
def test_weight_bridge_is_strict_both_ways(fusion):
    """Every key of the port's ``state_dict()`` maps to its JAX path by the
    JAX importer's rules, every JAX leaf comes back under the port's key
    (``strict=True``), and the values round-trip exactly."""
    img = np.zeros((1, 128, 128, 3), np.float32)
    jm = jfus.MADNet2Fusion() if fusion else jmad.MADNet2()
    args = (img, img) + ((np.zeros((1, 128, 128, 1), np.float32),) if fusion else ())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    port = madnet2.make_madnet2(fusion=fusion, seed=4)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_state_dict(sd)  # the JAX importer's rules
    assert not stats
    want = {p: s.shape for p, s in _flat(shapes["params"]).items()}
    assert {p: v.shape for p, v in params.items()} == want
    assert len(params) == len(sd)
    back = state_dict_from_jax({"params": _unflat(params)})
    fresh = madnet2.make_madnet2(fusion=fusion, seed=9)
    fresh.load_state_dict(back, strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def test_self_supervised_loss_is_the_ports_own():
    """The MAD objective's photometric term is ``losses.self_supervised_loss``
    of the port, held to the JAX one on a full-resolution disparity."""
    rng = np.random.RandomState(20)
    d = (rng.rand(2, 32, 64, 1) * 8).astype(np.float32)
    i1, i2 = ((rng.rand(2, 32, 64, 3) * 255).astype(np.float32) for _ in range(2))
    from raft_stereo_tpu_torch import losses

    _close(losses.self_supervised_loss(torch.from_numpy(d), torch.from_numpy(i1),
                                       torch.from_numpy(i2)),
           jlosses.self_supervised_loss(d, i1, i2), rtol=LOSS_RTOL, atol=0.0)
