"""What the MADNet2Fusion driver shares with its calibration: the
program's model and engine as ``evaluate_mad --fusion`` builds them, the
warm-up of the cell's shapes, and the comparison of the served answers
with the plain reference (``reference/madnet2_fusion.py``) once the window
has closed."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import harness, mad_weights, serving
from portbench.reference import madnet2_fusion as mref
from portbench.reference import model as ref


def state_dict(run: harness.Run, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, named by the reference's module tree."""
    with torch.device("meta"):
        shapes = mref.MADNet2FusionReference()
    return mad_weights.make_state_dict(shapes, run.seed, device, run.config["weights"])


def build_model(run: harness.Run):
    """The program's MADNet2Fusion with the seeded weights, in the
    configuration's precision, on the run's device."""
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2

    model = make_madnet2(mixed_precision=bool(run.config["model"]["mixed_precision"]),
                         fusion=True)
    model = model.to(run.device)
    model.load_state_dict(state_dict(run, run.device), strict=True)
    return model.eval()


def build_engine(model, run: harness.Run):
    """``evaluate_mad.make_mad_engine(fusion=True)``: the engine
    ``evaluate_mad --fusion`` serves on, captured per (bucket, batch) on the
    card."""
    from raft_stereo_tpu_torch import evaluate_mad
    from raft_stereo_tpu_torch.runtime.infer import InferOptions

    opts = InferOptions(batch=int(run.cell["batch"]), prefetch=int(run.cell.get("prefetch", 2)))
    return evaluate_mad.make_mad_engine(model, True, opts)


def warm_up(stream_fn, pool, batch: int, divis_by: int) -> None:
    """``serving.warm_up`` for inputs of any number of slots: two full
    micro-batches of every bucket the pool holds, through the timed
    entry."""
    from raft_stereo_tpu_torch.ops.pad import bucket_shape
    from raft_stereo_tpu_torch.runtime.infer import InferRequest

    by_bucket: Dict[Tuple[int, int], List[int]] = {}
    for i, inputs in enumerate(pool):
        by_bucket.setdefault(bucket_shape(*inputs[0].shape[:2], divis_by), []).append(i)
    picks = [m[k % len(m)] for m in by_bucket.values() for k in range(2 * batch)]
    for res in stream_fn(iter([InferRequest(payload=i, inputs=pool[i]) for i in picks])):
        if not res.ok:
            raise harness.NoResult(f"warm-up request failed: {res.error!r}")
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def reference_outputs(run: harness.Run, pool, indices, **precision) -> Dict[int, np.ndarray]:
    """The reference's served disparity [H, W] for each pool pair in
    ``indices``, in ``mref.set_precision(**precision)`` (float32 by
    default), one pair at a time, its window and attention in blocks of
    the cell's ``reference_block_rows`` rows."""
    with torch.device("meta"):
        m = mref.MADNet2FusionReference()
    m = m.to_empty(device=run.device)
    m.load_state_dict(state_dict(run, run.device), strict=True)
    m = mref.set_precision(m.eval(), **precision)
    m.block_rows = run.cell.get("reference_block_rows")
    out = {}
    with ref.strict_fp32():
        for idx in indices:
            inputs = [torch.from_numpy(x).to(run.device) for x in pool[idx]]
            out[idx] = mref.predict(m, *inputs).cpu().numpy()
    return out


def tf32_convs(engine, model, pool, batch: int) -> Optional[List[str]]:
    """The program's convolutions that cuDNN runs in TF32, by name (the
    reference's names too; ``conv_precisions``), on the card. cuDNN picks
    a kernel by shape, and some (a few input channels, a 1x1 kernel) run
    in float32 whatever ``allow_tf32`` says. None off the card, where the
    program has no TF32: every convolution then counts as the stated
    precision's."""
    if engine.device.type != "cuda":
        return None
    return sorted(n for n, tf32 in conv_precisions(engine, model, pool, batch).items() if tf32)


def conv_precisions(engine, model, pool, batch: int) -> Dict[str, bool]:
    """For each convolution of one eager forward of a batch of the pool,
    padded as the engine pads it: whether it ran in TF32, i.e. whether its
    output lies nearer the float32 convolution of its inputs and weights
    rounded to TF32 than the float32 convolution of them as they are."""
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.ops.pad import BatchPadder

    picks = [pool[i % len(pool)] for i in range(batch)]
    padder = BatchPadder([p[0].shape[:2] for p in picks], divis_by=engine.divis_by)
    inputs = [torch.from_numpy(padder.pad([p[k] for p in picks])).to(engine.device)
              for k in range(len(picks[0]))]
    votes: Dict[str, List[bool]] = {}

    def probe(name):
        def hook(mod, args, out):
            x, w = args[0], mod.weight
            with ref.strict_fp32():
                full = F.conv2d(x, w, mod.bias, mod.stride, mod.padding, mod.dilation, mod.groups)
                rounded = F.conv2d(mref.round_tf32(x), mref.round_tf32(w), mod.bias, mod.stride,
                                   mod.padding, mod.dilation, mod.groups)
            near = float((out - rounded).abs().mean()) < float((out - full).abs().mean())
            votes.setdefault(name, []).append(near)
        return hook

    hooks = [m.register_forward_hook(probe(n)) for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        engine.forward_fn(*inputs)
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    if any(len(set(v)) > 1 for v in votes.values()):
        raise harness.NoResult(f"a convolution ran in two precisions: {votes}")
    return {n: v[0] for n, v in votes.items()}


# the configured precision's yardstick: TF32 convolutions, those the probe
# finds (``tf32_convs``), the rest float32
CONFIGURED = {"convs": "tf32"}
# the controls the limit must tell from a sound run: one step below the
# stated precision, and the mechanism bypassed
CONTROLS = {"bf16": {"convs": "bf16", "corr": "bf16", "attn": "bf16"},
            "no_attention": {"bypass_attention": True}}
# read by the calibration, not held to the limit: matrix products in TF32
# (the configured precision with ``cuda.matmul.allow_tf32`` on)
TF32_PRODUCTS = {"corr": "tf32", "attn": "tf32"}
# the percentiles of a pair's per-pixel gap that the calibration reads
PERCENTILES = (50, 90, 99)
# the checked statistic, a pair's 99th percentile of the per-pixel gap, and
# the name of its check
STAT, CHECK = "p99", "disp_p99_gap_ratio"


def configured(run: harness.Run) -> Dict:
    """``CONFIGURED`` for the run: its convolutions those the probe found
    TF32 (all of them off the card)."""
    names = run.notes.get("tf32_convs")
    return dict(CONFIGURED, **({} if names is None else {"conv_names": names}))


def gap_stats(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """A pair's per-pixel |got - want| in pixels: its mean and percentiles."""
    gap = np.abs(got.reshape(want.shape) - want).ravel()
    out = {"mean": float(gap.mean())}
    for q, v in zip(PERCENTILES, np.percentile(gap, PERCENTILES)):
        out[f"p{q}"] = float(v)
    return out


def gap_ratios(run: harness.Run, pool, samples) -> Tuple[List[Dict], List[Dict]]:
    """For each sampled (pool index, disparity) answer: the statistics of
    its gap in pixels to the float32 reference, and those of the reference
    itself in the configured precision (``configured``), the yardstick of
    how far that precision carries this seed's weights."""
    indices = [i for i, _ in samples]
    want = reference_outputs(run, pool, indices)
    own = reference_outputs(run, pool, indices, **configured(run))
    return ([gap_stats(out, want[i]) for i, out in samples],
            [gap_stats(own[i], want[i]) for i in indices])


def check_outputs(run: harness.Run, pool, samples) -> None:
    """``correct``: the widest, over the sampled answers, of the answer's
    gap statistic ``STAT`` to the float32 reference over the configured
    precision's own, against the cell's limit."""
    t0 = time.perf_counter()
    gaps, scales = gap_ratios(run, pool, samples)
    ratios = [g[STAT] / s[STAT] for g, s in zip(gaps, scales)]
    run.checks[CHECK] = [max(ratios) if ratios else float("inf"),
                         float(run.cell["limits"][CHECK])]
    run.notes["reference"] = {"pairs": len(gaps), "gaps_px": gaps, "configured_gaps_px": scales,
                              "seconds": time.perf_counter() - t0}
