"""Training, the model and ops layer: the port's train-mode forward, its
gradients, the loss suite, the K1 and K3 backward helpers and the
optimizer against the JAX package, on the CPU in fp32.

Weights: one JAX init with seeded random norm statistics and biases,
carried over with ``state_dict_from_jax``; the same tree map turns JAX's
gradient tree into the port's parameter names. One JAX gradient
computation per lookup backend is shared through a module-scoped fixture
(the JAX compiles are the cost).

Tolerances, each stated where it is checked:

  * the train-mode stack: 1e-4 of its largest magnitude; the loss: 1e-5
    relative (fp32 sums in another order);
  * every parameter's gradient outside the feature encoder: max|Δ| <=
    1e-4·max|g_jax| + 1e-7 per tensor. The feature encoder (``fnet``)
    feeds its instance norms into relus, and each framework decides the
    sign of a pre-activation within rounding of zero by its own fp32
    statistics: one flipped relu at one of the 512 positions of a 16x32
    layer moves every weight gradient upstream of it by about 1/512 of its
    scale. Measured on the CPU: the port against JAX up to 2.9e-2 of the
    scale in ``fnet`` at 32x64 (and 1.1e-1 for the encoder alone on four
    32x64 images), so in the whole-model comparison ``fnet``'s weight
    gradients are held to FNET_RTOL = 5e-2 of the scale. The encoder's
    gradients are held to the 1e-4 rule on their own, through its VJP on
    two 16x32 images: there no pre-activation lies within rounding of
    zero (measured: 3.9e-6 of the scale at most). A conv bias that
    feeds an affine-free instance norm has a zero gradient: both sides
    must give rounding noise, below ZERO_GRAD_RTOL = 1e-5 of the
    same conv's weight-gradient scale;
  * remat on against off: 1e-6 relative (the same arithmetic run twice,
    but recomputed activations may be reassociated);
  * the K1 and K3 backward helpers against ``jax.vjp`` of the Pallas
    kernels (interpreted): 1e-5 relative;
  * the optimizer against optax: 1e-6 relative after 5 updates; the
    schedule exactly, in float64.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_stereo_tpu import losses as jlosses
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.experiments import pallas_packed_conv as jppc
from raft_stereo_tpu.experiments.packed_conv import pack_kernel_3x3
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops import pallas_corr as jpc
from raft_stereo_tpu.ops import sampling as jsampling
from raft_stereo_tpu.ops.corr import pool_fmap_pyramid as jpool
from raft_stereo_tpu.parallel.train_step import onecycle_linear as jax_onecycle
from raft_stereo_tpu_torch import losses
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.experiments import packed_conv
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import alt_corr, fused_update, sampling
from raft_stereo_tpu_torch.ops.corr import pool_fmap_pyramid
from raft_stereo_tpu_torch.parallel.train_step import (
    apply_update,
    create_train_state,
    make_optimizer,
    onecycle_linear,
)
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

B, H, W = 2, 32, 64
ITERS = 2
HIDDEN = (32, 32, 32)
STACK_TOL = 1e-4  # of max |stack|
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7  # of max |g_jax|, per tensor
FNET_RTOL = 5e-2  # the feature encoder's weight gradients (see the docstring)
ZERO_GRAD_RTOL = 1e-5  # a bias before an instance norm, of its conv's weight gradient
REMAT_RTOL = 1e-6
VJP_RTOL = 1e-5
OPT_RTOL = 1e-6


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


@functools.lru_cache(maxsize=None)
def _variables():
    model = JaxRAFTStereo(JaxConfig(hidden_dims=HIDDEN))
    img = jnp.asarray(np.random.RandomState(0).rand(1, H, W, 3) * 255, jnp.float32)
    init = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))
    return _perturb(init(jax.random.PRNGKey(0)), seed=1)


def _batch():
    rng = np.random.RandomState(3)
    return {
        "img1": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "img2": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "flow": (rng.rand(B, H, W, 1) * 12.0).astype(np.float32),
        "valid": (rng.rand(B, H, W) > 0.2).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_run():
    """One JAX gradient computation per lookup backend, for the module."""
    return functools.lru_cache(maxsize=None)(_jax_run)


def _jax_run(backend):
    """The JAX stack, loss and parameter gradients, with torch names."""
    variables = _variables()
    model = JaxRAFTStereo(JaxConfig(hidden_dims=HIDDEN, corr_implementation=backend))
    b = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(params):
        preds = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            b["img1"], b["img2"], iters=ITERS)
        loss, _ = jlosses.sequence_loss(preds, b["flow"], b["valid"])
        return loss, preds

    (loss, preds), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    return np.asarray(preds), float(loss), {k: v.numpy() for k, v in grads.items()}


def _port_model(backend):
    model = RAFTStereo(RAFTStereoConfig(hidden_dims=HIDDEN, corr_implementation=backend))
    model.load_state_dict(state_dict_from_jax(_variables()), strict=True)
    return model.train()


@functools.lru_cache(maxsize=None)
def _port_run(backend, remat):
    model = _port_model(backend)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    preds = model(b["img1"], b["img2"], iters=ITERS, test_mode=False, remat=remat)
    loss, _ = losses.sequence_loss(preds, b["flow"], b["valid"])
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return preds.detach().numpy(), float(loss.detach()), grads


@functools.lru_cache(maxsize=None)
def _zero_gradient_biases():
    """{bias name: its conv's weight name} for every conv whose output goes
    straight into an affine-free instance norm (the norm removes the bias,
    so its exact gradient is zero): the feature encoder's convs."""
    from raft_stereo_tpu_torch.models.layers import InstanceNorm, ResidualBlock

    model = _port_model("reg")
    out = {}
    fnet = model.fnet
    pairs = [("conv1", fnet.norm1)]
    for lname in ("layer1", "layer2", "layer3"):
        for i, blk in enumerate(getattr(fnet, lname)):
            assert isinstance(blk, ResidualBlock)
            pairs += [(f"{lname}.{i}.conv1", blk.norm1), (f"{lname}.{i}.conv2", blk.norm2)]
            if blk.downsample is not None:
                pairs.append((f"{lname}.{i}.downsample.0", blk.norm3))
    for conv, norm in pairs:
        assert isinstance(norm, InstanceNorm)
        out[f"fnet.{conv}.bias"] = f"fnet.{conv}.weight"
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("backend", ["reg", "alt"])
def test_train_forward_loss_and_gradients_match_jax(jax_run, backend, remat):
    preds_j, loss_j, grads_j = jax_run(backend)
    preds_t, loss_t, grads_t = _port_run(backend, remat)
    assert preds_t.shape == preds_j.shape == (ITERS, B, H, W, 1)
    scale = np.abs(preds_j).max()
    assert np.abs(preds_t - preds_j).max() <= STACK_TOL * scale
    assert abs(loss_t - loss_j) <= LOSS_RTOL * abs(loss_j)
    assert set(grads_t) <= set(grads_j)
    zero = _zero_gradient_biases()
    reached = 0
    for name, g in grads_t.items():
        want = grads_j[name]
        assert g.shape == want.shape, name
        scale = np.abs(want).max()
        if name in zero:
            wscale = np.abs(grads_j[zero[name]]).max()
            assert max(np.abs(g).max(), scale) <= ZERO_GRAD_RTOL * wscale, name
            continue
        rtol = FNET_RTOL if name.startswith("fnet.") else GRAD_RTOL
        err = np.abs(g - want).max()
        assert err <= rtol * scale + GRAD_ATOL, (name, err, scale)
        reached += bool(scale > 0)
    assert reached > 0.9 * (len(grads_t) - len(zero))  # the loss reaches every parameter


@pytest.mark.parametrize("backend", ["reg", "alt"])
def test_remat_gradients_equal_plain_ones(backend):
    _, loss_a, grads_a = _port_run(backend, False)
    _, loss_b, grads_b = _port_run(backend, True)
    assert loss_a == loss_b
    for name, g in grads_a.items():
        scale = max(np.abs(g).max(), 1e-30)
        assert np.abs(grads_b[name] - g).max() <= REMAT_RTOL * scale, name


def test_feature_encoder_gradients_match_jax():
    """The feature encoder's VJP, every parameter and the input, against
    JAX's at the 1e-4 rule (see the module docstring for the size)."""
    from raft_stereo_tpu.models.extractor import BasicEncoder

    rng = np.random.RandomState(7)
    x = (rng.rand(2, 16, 32, 3) * 2 - 1).astype(np.float32)
    ct = rng.randn(2, 4, 8, 256).astype(np.float32)
    jmod = BasicEncoder(output_dim=256, norm_fn="instance", downsample=2)
    gp, gx = jax.jit(lambda p, v, c: jax.vjp(lambda q, u: jmod.apply({"params": q}, u),
                                             p, v)[1](c))(
        _variables()["params"]["fnet"], jnp.asarray(x), jnp.asarray(ct))
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": {"fnet": jax.tree_util.tree_map(np.asarray, gp)}}).items()}
    want["input"] = np.asarray(gx)
    fnet = _port_model("reg").fnet
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    fnet(xt).backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    got = {f"fnet.{n}": p.grad.numpy() for n, p in fnet.named_parameters()}
    got["input"] = xt.grad.permute(0, 2, 3, 1).numpy()
    zero = _zero_gradient_biases()
    for name, g in got.items():
        ref = want[name]
        scale = np.abs(ref).max()
        if name in zero:
            wscale = np.abs(want[zero[name]]).max()
            assert max(np.abs(g).max(), scale) <= ZERO_GRAD_RTOL * wscale, name
            continue
        err = np.abs(g - ref).max()
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (name, err, scale)


def test_train_mode_detaches_the_flow_and_ignores_test_options():
    """No gradient reaches the previous iteration through the flow carry,
    and fused_update / converge_eps leave train mode unchanged."""
    model = _port_model("alt")
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ref = model(b["img1"], b["img2"], iters=ITERS, test_mode=False)
    model.config = dataclasses.replace(model.config, fused_update=True, converge_eps=0.5)
    got = model(b["img1"], b["img2"], iters=ITERS, test_mode=False)
    assert torch.equal(got, ref)
    # a test-mode forward is still the default, without gradients
    low, up, ran = model(b["img1"], b["img2"], iters=ITERS)
    assert not up.requires_grad and ran >= 1


# ------------------------------------------------------------------ losses


def test_loss_suite_matches_jax():
    rng = np.random.RandomState(5)
    preds = (rng.randn(4, 2, 12, 16, 1) * 3).astype(np.float32)
    gt = (rng.randn(2, 12, 16, 1) * 3).astype(np.float32)
    gt[0, 0, 0, 0] = 900.0  # beyond max_flow: masked
    valid = (rng.rand(2, 12, 16) > 0.3).astype(np.float32)
    for n in (1, 4):
        lj, mj = jlosses.sequence_loss(jnp.asarray(preds[:n]), jnp.asarray(gt), jnp.asarray(valid))
        lt, mt = losses.sequence_loss(torch.from_numpy(preds[:n]), torch.from_numpy(gt),
                                      torch.from_numpy(valid))
        assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
        for k in ("epe", "1px", "3px", "5px"):
            assert abs(float(mt[k]) - float(mj[k])) <= 1e-6 * max(1.0, abs(float(mj[k]))), k
    im1 = rng.rand(2, 12, 16, 3).astype(np.float32)
    im2 = rng.rand(2, 12, 16, 3).astype(np.float32)
    disp = (rng.rand(2, 12, 16, 1) * 4).astype(np.float32)
    pairs = [
        (jlosses.ssim_distance(jnp.asarray(im1), jnp.asarray(im2)),
         losses.ssim_distance(torch.from_numpy(im1), torch.from_numpy(im2))),
        (jlosses.smooth_grad(jnp.asarray(disp), jnp.asarray(im1), 1.0, order=2),
         losses.smooth_grad(torch.from_numpy(disp), torch.from_numpy(im1), 1.0, order=2)),
        (jlosses.disp_warp(jnp.asarray(im2), jnp.asarray(disp)),
         losses.disp_warp(torch.from_numpy(im2), torch.from_numpy(disp))),
        (jlosses.self_supervised_loss(jnp.asarray(disp), jnp.asarray(im1), jnp.asarray(im2)),
         losses.self_supervised_loss(torch.from_numpy(disp), torch.from_numpy(im1),
                                     torch.from_numpy(im2))),
        (jlosses.kitti_metrics(jnp.asarray(disp), jnp.asarray(disp + 0.5), jnp.asarray(valid[..., None]))["bad 3"],
         losses.kitti_metrics(torch.from_numpy(disp), torch.from_numpy(disp + 0.5),
                              torch.from_numpy(valid[..., None]))["bad 3"]),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bilinear_sampler_matches_jax():
    rng = np.random.RandomState(6)
    img = rng.randn(2, 9, 13, 3).astype(np.float32)
    coords = (rng.rand(2, 5, 7, 2) * [16, 12] - [2, 2]).astype(np.float32)
    want = jsampling.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords))
    got = sampling.bilinear_sampler(torch.from_numpy(img), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------- K1 and K3 backward helpers


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


def test_alt_lookup_vjp_matches_the_jax_custom_vjp():
    rng = np.random.RandomState(7)
    Bc, Hc, W1, D, L, r = 2, 3, 21, 16, 3, 2
    f1 = rng.randn(Bc, Hc, W1, D).astype(np.float32)
    f2 = rng.randn(Bc, Hc, W1, D).astype(np.float32)
    coords = np.round((np.arange(W1) - rng.rand(Bc, Hc, W1) * 8 + 1) * 64) / 64
    coords = coords.astype(np.float32)
    g = rng.randn(Bc, Hc, W1, L * (2 * r + 1)).astype(np.float32)
    pyr_j = jpool(jnp.asarray(f2), L)
    out, vjp = jax.vjp(
        lambda a, p, c: jpc.corr_lookup_alt_pallas(a, p, c, r, interpret=True),
        jnp.asarray(f1), pyr_j, jnp.asarray(coords))
    df1_j, dpyr_j, dc_j = vjp(jnp.asarray(g))
    pyr_t = [p.contiguous() for p in pool_fmap_pyramid(torch.from_numpy(f2), L)]
    df1, dpyr, dc = alt_corr.alt_lookup_vjp(torch.from_numpy(f1), pyr_t,
                                            torch.from_numpy(coords), r, torch.from_numpy(g))
    assert _rel_err(df1.numpy(), df1_j) <= VJP_RTOL
    assert len(dpyr) == L
    for got, want in zip(dpyr, dpyr_j):
        assert got.shape == want.shape and _rel_err(got.numpy(), want) <= VJP_RTOL
    assert np.all(np.asarray(dc_j) == 0) and torch.count_nonzero(dc) == 0
    # on the CPU the wrapper's own autograd gives the same, and no
    # coordinate gradient
    a = torch.from_numpy(f1).requires_grad_(True)
    levels = [p.detach().clone().requires_grad_(True) for p in pyr_t]
    c = torch.from_numpy(coords).requires_grad_(True)
    alt_corr.corr_lookup_alt(a, levels, c, r).backward(torch.from_numpy(g))
    assert _rel_err(a.grad.numpy(), df1_j) <= VJP_RTOL
    assert all(_rel_err(lv.grad.numpy(), w) <= VJP_RTOL for lv, w in zip(levels, dpyr_j))
    assert c.grad is None


@pytest.mark.parametrize("prologue", [None, "relu"])
def test_packed_conv_vjp_matches_the_jax_custom_vjp(monkeypatch, prologue):
    monkeypatch.setattr(jppc, "_INTERPRET", True)
    rng = np.random.RandomState(8)
    Bc, Hc, Wc = 2, 8, 12
    xp = rng.randn(Bc, Hc, Wc // 2, 128).astype(np.float32)
    w = (rng.randn(3, 3, 64, 64) * 0.06).astype(np.float32)
    g = rng.randn(Bc, Hc, Wc // 2, 128).astype(np.float32)
    scale = shift = None
    if prologue:
        scale = (0.5 + rng.rand(Bc, 128)).astype(np.float32)
        shift = (rng.rand(Bc, 128) - 0.3).astype(np.float32)
        fn = lambda x, k, s, t: jppc.packed_conv3x3_pallas(x, pack_kernel_3x3(k), s, t, True)
        args = (jnp.asarray(xp), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift))
    else:
        fn = lambda x, k: jppc.packed_conv3x3_pallas(x, pack_kernel_3x3(k), None, None, False)
        args = (jnp.asarray(xp), jnp.asarray(w))
    _, vjp = jax.vjp(fn, *args)
    want = vjp(jnp.asarray(g))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = packed_conv.packed_conv_vjp(t(xp), t(w), t(scale), t(shift), bool(prologue), t(g))
    assert len([x for x in got if x is not None]) == len(want)
    for gt, wt in zip(got, want):
        assert tuple(gt.shape) == wt.shape and _rel_err(gt.numpy(), wt) <= VJP_RTOL
    # through pack_weight the gradient reaches the conv's own OIHW weight
    conv_w = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_(True)
    x = torch.from_numpy(xp).requires_grad_(True)
    out = packed_conv.packed_conv3x3(x, packed_conv.pack_weight(conv_w, torch.float32),
                                     t(scale), t(shift), bool(prologue))
    out.backward(t(g))
    assert _rel_err(x.grad.numpy(), want[0]) <= VJP_RTOL
    assert _rel_err(conv_w.grad.numpy().transpose(2, 3, 1, 0), want[1]) <= VJP_RTOL


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("lr,num_steps", [(2e-4, 100_000), (1e-3, 7), (3e-4, 1234)])
def test_schedule_equals_jax_onecycle_in_float64(lr, num_steps):
    with jax.enable_x64(True):
        jsched = jax_onecycle(lr, num_steps + 100)
        counts = sorted({0, 1, 2, 3, 5, 8, 10, 11, 12, 13, num_steps // 2, num_steps - 1,
                         num_steps, num_steps + 99, num_steps + 100, num_steps + 150})
        want = [float(jsched(jnp.asarray(c, jnp.int64))) for c in counts]
    sched = onecycle_linear(lr, num_steps + 100)
    assert [sched(c) for c in counts] == want
    # the k-th update uses schedule(k - 1)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, lr_sched, _ = make_optimizer([p], TrainConfig(lr=lr, num_steps=num_steps))
    for k in range(1, 14):
        assert opt.param_groups[0]["lr"] == sched(k - 1)
        p.grad = torch.ones(3)
        opt.step()
        lr_sched.step()


def _toy_state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    return create_train_state(model, TrainConfig(lr=1e-2, num_steps=20, wdecay=1e-2))


def _fixed_grads(step, shapes, scale):
    rng = np.random.RandomState(100 + step)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("scale", [0.01, 3.0])  # below and above the clip
def test_update_matches_optax_adamw_with_clipping(scale):
    state = _toy_state()
    params = list(state.model.parameters())
    shapes = [tuple(p.shape) for p in params]
    jparams = [jnp.array(p.detach().numpy(), copy=True) for p in params]  # no aliasing
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jax_onecycle(1e-2, 120), weight_decay=1e-2, eps=1e-8))
    jstate = tx.init(jparams)
    for step in range(5):
        grads = _fixed_grads(step, shapes, scale)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        apply_update(state, torch.tensor(1.0), {})
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert state.step == 5
    for p, want in zip(params, jparams):
        assert _rel_err(p.detach().numpy(), want) <= OPT_RTOL


def test_guard_skips_exactly_the_nan_step_bitwise():
    state = _toy_state(1)
    params = list(state.model.parameters())
    shapes = [tuple(p.shape) for p in params]
    skipped = []
    for step in range(1, 4):
        grads = _fixed_grads(step, shapes, 1.0)
        if step == 2:
            grads[0][0, 0] = np.nan
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        before = ([p.detach().clone() for p in params],
                  {k: v.clone() for k, v in state.optimizer.state[params[0]].items()}
                  if step > 1 else {}, state.lr, state.scheduler.last_epoch)
        _, metrics = apply_update(state, torch.tensor(float("nan") if step == 2 else 1.0),
                                  {"epe": torch.tensor(float("nan") if step == 2 else 0.5)},
                                  nonfinite_guard=True)
        skipped.append(metrics["skipped"])
        if step == 2:
            assert all(torch.equal(a, p) for a, p in zip(before[0], params))
            moments = state.optimizer.state[params[0]]
            assert all(torch.equal(before[1][k], moments[k]) for k in moments)
            assert (state.lr, state.scheduler.last_epoch) == before[2:]
            assert float(metrics["epe"]) == 0.0 and float(metrics["live_loss"]) == 0.0
        else:
            assert not all(torch.equal(a, p) for a, p in zip(before[0], params))
    assert skipped == [0.0, 1.0, 0.0] and state.step == 3
    assert state.scheduler.last_epoch == 2  # two applied updates
