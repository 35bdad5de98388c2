"""RAFT-Stereo test-mode inference with each request's rows split into
slabs over a list of devices (the spatial tier; the JAX package gets it
from GSPMD partitioning ``models/raft_stereo.py`` over the mesh's
``spatial`` axis, ``runtime/infer.py:755-766,1150-1153``).

``SpatialRAFTStereo(model, devices).forward`` returns what
``model.forward(test_mode=True)`` returns. It walks the same modules as
``models/raft_stereo.py`` on the model's own parameters (one copy of the
model on each other device the list names), through the sharded ops of
``parallel/spatial.py``: convs take halo rows from their neighbours,
instance and group norms use global moments, the resizes between GRU
levels sample in global row coordinates, and convex upsampling reads a
halo row of the flow. Each slab builds its own correlation state from its
own rows (``reg`` its slab of the volume, ``alt`` launches K1 on its slab),
since correlation never mixes rows.

With ``fused_update`` each slab runs K2 (``ops.fused_update.
fused_refine_step``) on itself extended by ``K2_HALO_ROWS`` rows of every
input taken from its neighbours, and keeps its own rows of the result.

With the packed encoder stage on (``models.extractor._ENABLE_PACKED``) a
trunk whose whole-image geometry passes ``packed_encoder.packable_hw`` (the
gate sees the global H, as the JAX gate sees the global array, so sharded
and unsharded forwards take the same path) runs its stem through the
sharded stock conv, its norms with global moments, and each of layer1's
four 3x3 convs as K3 (``packed_encoder.conv3x3``) on each slab extended by
``K3_HALO_ROWS`` rows above and below (zeros at the global ends), the
extension cropped away: 4·k K3 launches a trunk on k active shards. A slab
geometry K3 refuses raises, naming the slab.
With ``converge_eps`` the loop stops on the largest per-sample mean
|delta| over the whole image, summed across the shards.

H must be a whole number of ``unit`` rows, 2^(n_downsample + n_gru_layers
- 1), so every pyramid level of every slab has whole rows; the units are
spread over the shards as evenly as possible (``spatial.row_split``), and
with fewer units than shards the trailing shards do no work. With one
shard (or one that holds rows) the model's own forward runs.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch

from raft_stereo_tpu_torch.experiments import packed_encoder
from raft_stereo_tpu_torch.models import extractor
from raft_stereo_tpu_torch.models.layers import GroupNorm, InstanceNorm
from raft_stereo_tpu_torch.models.raft_stereo import TWO_CALL_FNET_PIXELS, RAFTStereo
from raft_stereo_tpu_torch.ops import fused_update
from raft_stereo_tpu_torch.ops.corr import make_corr_fn
from raft_stereo_tpu_torch.ops.sampling import coords_grid
from raft_stereo_tpu_torch.parallel import spatial
from raft_stereo_tpu_torch.parallel.mesh import indexed_device

# Rows of each input that a K2 step's outputs depend on, on either side
# (csrc/fused_update.cu's seven stages): stage 1's convf1 is 7x7 (3 rows;
# the lookup and convc1 are per pixel), then one row each for the 3x3
# convs of stage 2 (convc2|convf2), stage 3 (the motion conv), stage 4
# (z|r) and stage 5 (q, on r·h): 7 rows for h'; stage 6 (the flow head's
# conv1) and stage 7 (its conv2) add two more for delta. A slab extended by
# 9 rows on a side shared with a neighbour gets its own rows exactly; the
# rows that the kernel's zero padding at the extended edge corrupts are the
# 9 it crops away. At the image's top and bottom the slab is not extended,
# and the kernel's zero padding is the image's.
K2_HALO_ROWS = 9

# Rows of its input a 3x3 SAME conv's output rows depend on, on either side:
# K3 on a slab extended by one row above and below gets the slab's own rows
# exactly, and its zero padding corrupts only the extension's rows.
K3_HALO_ROWS = 1


def _each(fn, *sharded) -> List[torch.Tensor]:
    """``fn`` slab by slab."""
    return [fn(*xs) for xs in zip(*sharded)]


def _relu(x):
    return _each(torch.relu, x)


def _cat(parts, dim: int = 1):
    return _each(lambda *xs: torch.cat(xs, dim=dim), *parts)


class SpatialRAFTStereo:
    """A RAFT-Stereo model's test-mode forward over row slabs on
    ``devices`` (see the module docstring), with every option of the
    model's forward: both correlation backends (K1 per slab for ``alt``),
    the fused step (K2 per slab), the packed encoder stage (K3 per slab)
    and the convergence exit. The copies on devices other than the model's
    are made here: weights changed in the model later reach them only
    through a new ``SpatialRAFTStereo``."""

    def __init__(self, model: RAFTStereo, devices: Sequence):
        if not devices:
            raise ValueError("SpatialRAFTStereo needs at least one device")
        self.model = model
        self.config = cfg = model.config
        self.devices = [indexed_device(d) for d in devices]
        self.unit = 2 ** (cfg.n_downsample + cfg.n_gru_layers - 1)
        home = next(model.parameters()).device
        self._copies = {d: model if d == home else copy.deepcopy(model).to(d).eval()
                        for d in dict.fromkeys(self.devices)}
        self._names = {id(m): n for n, m in model.named_modules()}
        self._active: List[torch.device] = self.devices

    def active_shards(self, H: int) -> int:
        """How many shards hold rows of an H-row input."""
        return spatial.active(spatial.row_split(H, self.unit, len(self.devices)))

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    # ------------------------------------------------------- sharded ops

    def _local(self, module) -> list:
        """Each active slab's copy of one of the model's modules."""
        name = self._names[id(module)]
        return [self._copies[d].get_submodule(name) for d in self._active]

    def _conv(self, x, m, **kw):
        return spatial.conv2d(x, self._local(m), **kw)

    def _norm(self, x, m):
        if isinstance(m, InstanceNorm):
            return spatial.instance_norm(x, m.eps)
        if isinstance(m, GroupNorm):
            return spatial.group_norm(x, self._local(m))
        return _each(lambda t, mod: mod(t), x, self._local(m))  # per pixel

    def _interp(self, coarse, fine):
        return spatial.interp_bilinear(coarse, [t.shape[2] for t in fine], fine[0].shape[3])

    # ---------------------------------------------------------- encoders

    def _residual(self, x, blk):
        y = _relu(self._norm(self._conv(x, blk.conv1), blk.norm1))
        y = _relu(self._norm(self._conv(y, blk.conv2), blk.norm2))
        if blk.downsample is not None:
            x = self._norm(self._conv(x, blk.downsample[0]), blk.downsample[1])
        return _relu(_each(torch.add, x, y))

    def _layer(self, x, layer):
        for blk in layer:
            x = self._residual(x, blk)
        return x

    def _trunk(self, x, enc):
        H, W = sum(t.shape[2] for t in x), x[0].shape[3]
        x = _relu(self._norm(self._conv(x, enc.conv1), enc.norm1))
        if extractor._ENABLE_PACKED and packed_encoder.packable_hw(H, W, enc.norm_fn,
                                                                   enc.conv1.stride[0]):
            for blk in enc.layer1:  # stride 1, 64 -> 64, no shortcut conv
                y = _relu(self._norm(self._k3(x, blk.conv1), blk.norm1))
                y = _relu(self._norm(self._k3(y, blk.conv2), blk.norm2))
                x = _relu(_each(torch.add, x, y))
        else:
            x = self._layer(x, enc.layer1)
        for layer in (enc.layer2, enc.layer3):
            x = self._layer(x, layer)
        return x

    def _k3(self, x, m):
        """One of layer1's 3x3 convs as K3 on each slab extended by
        ``K3_HALO_ROWS`` rows above and below, cropped back to the slab's
        rows (``spatial.conv2d``'s rule with ``packed_encoder.conv3x3`` in
        place of the stock conv)."""
        R = K3_HALO_ROWS
        out = []
        for t, ext, mod in zip(x, spatial.halo(x, R, R), self._local(m)):
            try:
                y = packed_encoder.conv3x3(mod, ext.contiguous(memory_format=torch.channels_last))
            except (ValueError, TypeError) as e:
                raise ValueError(f"K3 cannot take the slab {tuple(ext.shape)} (NCHW, its "
                                 f"{R}-row halo included): {e}") from e
            out.append(y[:, :, R:R + t.shape[2]])
        return out

    def _head(self, x, head):
        """``Sequential(ResidualBlock, conv)``."""
        return self._conv(self._residual(x, head[0]), head[1])

    def _cnet(self, x, dual_inp=False):
        """``MultiBasicEncoder.forward``, level by level, head by head."""
        enc = self.model.cnet
        x = self._trunk(x, enc)
        v = None
        if dual_inp:
            v = x
            x = [t[: t.shape[0] // 2] for t in x]
        outs = [tuple(self._head(x, h) for h in enc.outputs08)]
        if enc.num_layers > 1:
            y = self._layer(x, enc.layer4)
            outs.append(tuple(self._head(y, h) for h in enc.outputs16))
        if enc.num_layers > 2:
            z = self._layer(y, enc.layer5)
            outs.append(tuple(self._conv(z, h) for h in enc.outputs32))
        return (*outs, v) if dual_inp else outs

    def _fnet(self, x):
        return self._conv(self._trunk(x, self.model.fnet), self.model.fnet.conv2)

    # ------------------------------------------------------ update block

    def _gru(self, m, h, cz, cr, cq, *xs):
        x = _cat(xs)
        hx = _cat([h, x])
        z = _each(lambda a, c: torch.sigmoid(a + c), self._conv(hx, m.convz), cz)
        r = _each(lambda a, c: torch.sigmoid(a + c), self._conv(hx, m.convr), cr)
        q = self._conv(_cat([_each(torch.mul, r, h), x]), m.convq)
        q = _each(lambda a, c: torch.tanh(a + c), q, cq)
        return _each(lambda z_, h_, q_: (1 - z_) * h_ + z_ * q_, z, h, q)

    def _motion(self, flow, corr):
        enc = self.model.update_block.encoder
        cor = _relu(self._conv(_relu(self._conv(corr, enc.convc1)), enc.convc2))
        flo = _relu(self._conv(flow, enc.convf1, in_slice=slice(0, 1)))
        flo = _relu(self._conv(flo, enc.convf2))
        out = _relu(self._conv(_cat([cor, flo]), enc.conv))
        return _each(lambda o, f: torch.cat([o, f, torch.zeros_like(f)], dim=1), out, flow)

    def _update(self, net, inp, corr=None, flow=None, iter08=True, iter16=True, iter32=True,
                update=True, with_mask=True):
        """``BasicMultiUpdateBlock.forward`` on slabs."""
        ub = self.model.update_block
        n = ub.n_gru_layers
        net = list(net)
        if iter32:
            net[2] = self._gru(ub.gru32, net[2], *inp[2], spatial.avg_pool2x(net[1]))
        if iter16:
            xs = [spatial.avg_pool2x(net[0])]
            if n > 2:
                xs.append(self._interp(net[2], net[1]))
            net[1] = self._gru(ub.gru16, net[1], *inp[1], *xs)
        if iter08:
            xs = [self._motion(flow, corr)]
            if n > 1:
                xs.append(self._interp(net[1], net[0]))
            net[0] = self._gru(ub.gru08, net[0], *inp[0], *xs)
        if not update:
            return net
        fh = ub.flow_head
        delta = self._conv(_relu(self._conv(net[0], fh.conv1)), fh.conv2,
                           out_slice=slice(0, 1))
        mask = None
        if with_mask:
            mask = self._conv(_relu(self._conv(net[0], ub.mask[0])), ub.mask[2])
            mask = [0.25 * t for t in mask]
        return net, mask, delta

    def _slow_fast(self, net, inp):
        n = self.config.n_gru_layers
        if self.config.slow_fast_gru:
            if n == 3:
                net = self._update(net, inp, iter32=True, iter16=False, iter08=False,
                                   update=False)
            if n >= 2:
                net = self._update(net, inp, iter32=n == 3, iter16=True, iter08=False,
                                   update=False)
        return net

    # ----------------------------------------------------------- forward

    def _encode(self, image1, image2, flow_init, corr_backend, bounds):
        cfg = self.config
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32

        def prep(img):
            x = (2.0 * (img / 255.0) - 1.0).to(dtype).permute(0, 3, 1, 2)
            return spatial.split(x, bounds, self._active)

        i1, i2 = prep(image1), prep(image2)
        if cfg.shared_backbone:
            *cnet_list, x = self._cnet(_cat([i1, i2], dim=0), dual_inp=True)
            f = self._conv(self._residual(x, self.model.conv2[0]), self.model.conv2[1])
            fmaps = [t.chunk(2, dim=0) for t in f]
        else:
            cnet_list = self._cnet(i1)
            if image1.shape[1] * image1.shape[2] > TWO_CALL_FNET_PIXELS:
                fmaps = list(zip(self._fnet(i1), self._fnet(i2)))
            else:
                fmaps = [t.chunk(2, dim=0) for t in self._fnet(_cat([i1, i2], dim=0))]
        net = [_each(torch.tanh, o[0]) for o in cnet_list]
        inp = []
        for zqr, o in zip(self.model.context_zqr_convs, cnet_list):
            gates = [t.chunk(3, dim=1) for t in self._conv(_relu(o[1]), zqr)]
            inp.append(tuple([g[j] for g in gates] for j in range(3)))
        corr_fns = [make_corr_fn(corr_backend, f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1),
                                 cfg.corr_levels, cfg.corr_radius) for f1, f2 in fmaps]
        B, _, _, W = net[0][0].shape
        coords0_x = [coords_grid(B, t.shape[2], W, device=t.device)[..., 0] for t in net[0]]
        flow_x = [torch.zeros((B, t.shape[2], W), dtype=torch.float32, device=t.device)
                  for t in net[0]]
        if flow_init is not None:
            f = cfg.downsample_factor
            low = spatial.split(flow_init[..., 0].float(), [(r0 // f, r1 // f)
                                                             for r0, r1 in bounds],
                                self._active, dim=1)
            flow_x = _each(torch.add, flow_x, low)
        return net, inp, corr_fns, coords0_x, flow_x

    def _step(self, net, inp, corr_fns, coords0_x, flow_x, with_mask):
        cfg = self.config
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        n = cfg.n_gru_layers
        corr = _each(lambda fn, c, f: fn(c + f).to(dtype).permute(0, 3, 1, 2),
                     corr_fns, coords0_x, flow_x)
        flow = [f[:, None].to(dtype) for f in flow_x]
        net = self._slow_fast(net, inp)
        net, up_mask, delta = self._update(net, inp, corr, flow, iter32=n == 3, iter16=n >= 2,
                                           with_mask=with_mask)
        return net, _each(lambda f, d: f + d[:, 0].float(), flow_x, delta), up_mask

    def _fused_state(self, inp, corr_fns, dtype):
        """What every fused step of a forward shares: each slab's packed
        weights, how many rows its extension adds above it, and its fmap1,
        pyramid and ctx extended."""
        R = K2_HALO_ROWS
        rows = [t.shape[2] for t in inp[0][0]]
        above = [min(R, sum(rows[:i])) for i in range(len(rows))]
        packed = {d: fused_update.pack_fused_params(self._copies[d].update_block, dtype)
                  for d in dict.fromkeys(self._active)}

        def grow(slabs):
            return spatial.halo(slabs, R, R, dim=1, zeros=False)

        ctx = [torch.cat(g, dim=1).permute(0, 2, 3, 1).contiguous()
               for g in zip(*inp[0])]
        levels = [grow([fn.fmap2_pyramid[lvl] for fn in corr_fns])
                  for lvl in range(len(corr_fns[0].fmap2_pyramid))]
        return {"packed": [packed[d] for d in self._active], "above": above, "grow": grow,
                "fmap1": grow([fn.fmap1 for fn in corr_fns]), "ctx": grow(ctx),
                "pyramid": [list(p) for p in zip(*levels)]}

    def _fused_step(self, net, inp, flow_x, state, dtype):
        """An unmasked iteration: the coarse GRU levels on slabs, then K2 on
        each slab extended by ``K2_HALO_ROWS`` rows, cropped back."""
        n = self.config.n_gru_layers
        net = self._slow_fast(net, inp)
        if n >= 2:
            net = self._update(net, inp, iter32=n == 3, iter16=True, iter08=False, update=False)
        grow = state["grow"]
        inp16 = [None] * len(flow_x)
        if n > 1:
            inp16 = grow([t.permute(0, 2, 3, 1) for t in self._interp(net[1], net[0])])
        h = grow([t.permute(0, 2, 3, 1) for t in net[0]])
        flows = grow(flow_x)
        h_new, deltas = [], []
        for i, a in enumerate(state["above"]):
            rows = flow_x[i].shape[1]
            hn, d = fused_update.fused_refine_step(
                state["packed"][i], state["fmap1"][i], state["pyramid"][i], flows[i], h[i],
                inp16[i], state["ctx"][i], self.config.corr_radius, compute_dtype=dtype)
            h_new.append(hn[:, a:a + rows].permute(0, 3, 1, 2))
            deltas.append(d[:, a:a + rows])
        return [h_new] + list(net[1:]), _each(torch.add, flow_x, deltas)

    def _max_delta(self, deltas, H, W):
        """``fused_update.batch_max_delta`` over the whole image."""
        sums = spatial.all_sum([d.float().abs().sum(dim=(1, 2)) for d in deltas])[0]
        return (sums / (H * W)).amax()

    @torch.no_grad()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None):
        """``RAFTStereo.forward(test_mode=True)`` over row slabs; outputs on
        the first device."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        bounds = spatial.row_split(image1.shape[1], self.unit, len(self.devices))
        n_active = spatial.active(bounds)
        dev0 = self.devices[0]
        if n_active == 1:
            model = self._copies[dev0]
            return model(image1.to(dev0), image2.to(dev0), iters=iters,
                         flow_init=None if flow_init is None else flow_init.to(dev0))
        self._active = self.devices[:n_active]
        cfg = self.config
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        net, inp, corr_fns, coords0_x, flow_x = self._encode(
            image1, image2, flow_init, "alt" if cfg.fused_update else cfg.corr_backend, bounds)
        fused = self._fused_state(inp, corr_fns, dtype) if cfg.fused_update else None
        Hl = sum(f.shape[1] for f in flow_x)
        Wl = flow_x[0].shape[2]
        ran = 0
        while ran < iters - 1:
            if fused is not None:
                net, new_flow = self._fused_step(net, inp, flow_x, fused, dtype)
            else:
                net, new_flow, _ = self._step(net, inp, corr_fns, coords0_x, flow_x, False)
            converged = cfg.converge_eps > 0 and float(self._max_delta(
                _each(torch.sub, new_flow, flow_x), Hl, Wl)) < cfg.converge_eps
            flow_x = new_flow
            ran += 1
            if converged:
                break
        net, flow_x, up_mask = self._step(net, inp, corr_fns, coords0_x, flow_x, True)
        masks = [m.float().permute(0, 2, 3, 1) for m in up_mask]
        disp_up = spatial.gather(spatial.convex_upsample(
            [f[..., None] for f in flow_x], masks, cfg.downsample_factor), dim=1)
        low = spatial.gather(flow_x, dim=1)
        lowres = torch.stack([low, torch.zeros_like(low)], dim=-1)
        return (lowres, disp_up, ran + 1) if cfg.converge_eps > 0 else (lowres, disp_up)
