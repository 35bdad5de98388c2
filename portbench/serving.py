"""What the inference drivers share: the program's model and engine as
``evaluate.py`` builds them, the warm-up of the cell's shapes, the seeded
sample of served results, and the comparison of those results with the
plain reference once the window has closed."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import harness, weights
from portbench.reference import model as ref


def model_dims(run: harness.Run) -> dict:
    """The configuration's architecture, with the lookup the cell runs."""
    return dict(run.config["model"], corr_implementation=run.cell["corr_implementation"])


def state_dict(run: harness.Run, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, named by the reference's module tree."""
    with torch.device("meta"):
        shapes = ref.RAFTStereoReference(model_dims(run))
    return weights.make_state_dict(shapes, run.seed, device, run.config["weights"])


def build_model(run: harness.Run):
    """The program's RAFT-Stereo with the seeded weights, on the run's
    device."""
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    dims = model_dims(run)
    cfg = RAFTStereoConfig(
        hidden_dims=tuple(dims["hidden_dims"]), corr_implementation=dims["corr_implementation"],
        shared_backbone=dims["shared_backbone"], corr_levels=dims["corr_levels"],
        corr_radius=dims["corr_radius"], n_downsample=dims["n_downsample"],
        context_norm=dims["context_norm"], slow_fast_gru=dims["slow_fast_gru"],
        n_gru_layers=dims["n_gru_layers"], mixed_precision=dims["mixed_precision"])
    with torch.device("meta"):
        model = RAFTStereo(cfg)
    model = model.to_empty(device=run.device)
    model.load_state_dict(state_dict(run, run.device), strict=True)
    return model.eval()


def build_engine(model, run: harness.Run):
    """``evaluate.make_engine``: the validators' engine, captured per
    (bucket, batch) on the card."""
    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.runtime.infer import InferOptions

    opts = InferOptions(batch=int(run.cell["batch"]), prefetch=int(run.cell.get("prefetch", 2)))
    return evaluate.make_engine(model, int(run.cell["iters"]), opts)


def warm_up(stream_fn, pool, batch: int) -> None:
    """Two full micro-batches of every bucket the pool holds, through the
    timed entry: the first compiles (warm-up and capture), the second
    replays."""
    from raft_stereo_tpu_torch.ops.pad import bucket_shape
    from raft_stereo_tpu_torch.runtime.infer import InferRequest

    by_bucket: Dict[Tuple[int, int], List[int]] = {}
    for i, (left, _) in enumerate(pool):
        by_bucket.setdefault(bucket_shape(*left.shape[:2]), []).append(i)
    picks = [m[k % len(m)] for m in by_bucket.values() for k in range(2 * batch)]
    for res in stream_fn(iter([InferRequest(payload=i, inputs=pool[i]) for i in picks])):
        if not res.ok:
            raise harness.NoResult(f"warm-up request failed: {res.error!r}")
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Sampler:
    """The results the comparison reads: ``k`` distinct pairs of the pool,
    drawn from the seed, each at its first served result."""

    def __init__(self, k: int, pool: int, seed: int):
        rng = np.random.default_rng([int(seed), 4])
        self.chosen = {int(i) for i in rng.choice(pool, size=min(int(k), pool), replace=False)}
        self.got: Dict[int, np.ndarray] = {}

    def offer(self, pool_index: int, output: np.ndarray) -> None:
        if pool_index in self.chosen and pool_index not in self.got:
            self.got[pool_index] = output

    @property
    def items(self) -> List[Tuple[int, np.ndarray]]:
        return sorted(self.got.items())


def free() -> None:
    """Return the program's freed state to the card before the reference
    runs (the caller drops its references first)."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_model(run: harness.Run, convs: str = "fp32",
                    state: str = "fp32") -> ref.RAFTStereoReference:
    """The reference with the run's weights, on the run's device, in the
    given precision (``ref.set_precision``); run it under
    ``ref.strict_fp32()``."""
    with torch.device("meta"):
        m = ref.RAFTStereoReference(model_dims(run))
    m = m.to_empty(device=run.device)
    m.load_state_dict(state_dict(run, run.device), strict=True)
    return ref.set_precision(m.eval(), convs, state)


def reference_outputs(run: harness.Run, pool, indices, convs: str = "fp32",
                      state: str = "fp32") -> Dict[int, np.ndarray]:
    """The reference's x-flow [H, W] for each pool pair in ``indices``, in
    the given precision (``ref.set_precision``): float32 by default; the
    control is ``("fp8", "bf16")``, one step below what the configurations
    state."""
    m = reference_model(run, convs, state)
    iters = int(run.cell["iters"])
    out = {}
    with ref.strict_fp32():
        for idx in indices:
            left, right = (torch.from_numpy(x).to(run.device) for x in pool[idx])
            out[idx] = ref.predict(m, left, right, iters).cpu().numpy()
    return out


def mean_gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.reshape(want.shape) - want).mean())


def gap_ratios(run: harness.Run, pool, samples) -> Tuple[List[float], List[float]]:
    """For each sampled (pool index, x-flow) answer: its mean gap in pixels
    to the float32 reference, and the gap of the reference itself computed
    in the configured precision (bf16 convolutions, the rest float32), the
    yardstick of how far that precision carries this seed's weights."""
    indices = [i for i, _ in samples]
    want = reference_outputs(run, pool, indices)
    own = reference_outputs(run, pool, indices, "bf16", "fp32")
    return ([mean_gap(out, want[i]) for i, out in samples],
            [mean_gap(own[i], want[i]) for i in indices])


def check_outputs(run: harness.Run, pool, samples) -> None:
    """The comparison that decides ``correct`` for an inference cell: the
    widest, over the sampled answers, of the answer's mean gap to the
    float32 reference over the configured precision's own gap, against its
    limit."""
    t0 = time.perf_counter()
    gaps, scales = gap_ratios(run, pool, samples)
    ratios = [g / s for g, s in zip(gaps, scales)]
    run.checks["disp_gap_ratio"] = [max(ratios) if ratios else float("inf"),
                                    float(run.cell["limits"]["disp_gap_ratio"])]
    run.notes["reference"] = {"pairs": len(gaps), "gaps_px": gaps, "bf16_gaps_px": scales,
                              "seconds": time.perf_counter() - t0}
