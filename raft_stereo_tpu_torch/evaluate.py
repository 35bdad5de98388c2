"""Evaluation harness: model construction, the test-mode forward, the
batched serving engine, the four validators and the CLI (PyTorch port of
``raft_stereo_tpu/evaluate.py``).

    python -m raft_stereo_tpu_torch.evaluate --dataset eth3d [--preset P]

The validators keep the reference's metrics, thresholds and masks:

  * ETH3D: bad-1.0 over valid pixels;
  * KITTI: bad-3.0 (D1), and a frames-per-second figure;
  * FlyingThings3D: bad-1.0 under the |disp| < 192 mask, pooled per pixel;
  * Middlebury: bad-2.0 where valid >= -0.5 and the GT > -1000.

By default every validator streams through the batched engine
(``runtime.infer.InferenceEngine``): shape buckets, fixed micro-batches and,
on the card, one CUDA graph per (bucket, batch). ``--per_image`` keeps the
reference's one-pair-at-a-time protocol, whose forward (``make_forward``) is
captured once per input shape on the card. Per-image metrics fold in
dataset index order on both paths. KITTI's per-pair FPS is defined on the
per-image path; the engine reports its throughput with capture time
excluded instead.

Everything here runs on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request it raises. On
the CPU both paths run the forward eagerly.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from raft_stereo_tpu_torch.config import (
    CORR_IMPLEMENTATIONS,
    PRESET_FLAGS,
    RAFTStereoConfig,
    apply_preset_defaults,
    config_from_args,
)
from raft_stereo_tpu_torch.data import datasets
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.pad import InputPadder
from raft_stereo_tpu_torch.runtime import infer as infer_mod
from raft_stereo_tpu_torch.runtime.infer import (
    GraphCache,
    InferenceEngine,
    InferOptions,
    InferRequest,
    add_infer_args,
    options_from_args,
)
from raft_stereo_tpu_torch.utils.weights import load_reference_pth

logger = logging.getLogger(__name__)

def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the CUDA card, which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def load_model(args_or_config, device=None, seed: int = 0,
               restore_ckpt: Optional[str] = None) -> RAFTStereo:
    """Build the model from a config or CLI args, initialised from a seeded
    ``torch.Generator``, optionally loading a reference ``.pth``, in eval
    mode on ``device``."""
    dev = resolve_device(device)
    if isinstance(args_or_config, RAFTStereoConfig):
        cfg = args_or_config
    else:
        cfg = config_from_args(args_or_config)
        restore_ckpt = restore_ckpt or getattr(args_or_config, "restore_ckpt", None)
    model = RAFTStereo(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    if restore_ckpt:
        load_reference_pth(model, restore_ckpt)
    logger.info("Parameter Count: %d", sum(p.numel() for p in model.parameters()))
    return model.to(dev).eval()


def make_forward(model: RAFTStereo, iters: int) -> Callable:
    """Test-mode forward: (img1, img2) [B, H, W, 3] numpy or tensors →
    disp_up [B, f·H, f·W, 1] on the model's device.

    On the card, with ``converge_eps == 0``, the forward is captured once
    per input shape as a CUDA graph and replayed (``forward.graphs`` is its
    ``GraphCache``; each call returns a fresh tensor). The ``converge_eps``
    exit reads a scalar back each step, so that forward runs eagerly, as
    does every forward on the CPU (``forward.graphs`` is then None)."""
    dev = next(model.parameters()).device

    def eager(a, b) -> torch.Tensor:
        # the forward returns (lowres, disp_up) or, with converge_eps,
        # (lowres, disp_up, iters_executed)
        return model(a, b, iters=iters)[1]

    graphs = (GraphCache() if dev.type == "cuda" and model.config.converge_eps == 0
              else None)

    def forward(img1, img2) -> torch.Tensor:
        if graphs is None:
            return eager(torch.as_tensor(img1, dtype=torch.float32, device=dev),
                         torch.as_tensor(img2, dtype=torch.float32, device=dev))
        a = torch.as_tensor(img1, dtype=torch.float32)
        b = torch.as_tensor(img2, dtype=torch.float32)
        key = (tuple(a.shape), tuple(b.shape), iters)
        return graphs.run(key, eager, (a, b)).clone()

    forward.graphs = graphs
    return forward


def make_engine(model: RAFTStereo, iters: int, infer: InferOptions) -> InferenceEngine:
    """The batched serving engine for the model's test-mode forward, on the
    model's device: captured per (bucket, batch) on the card unless the
    model's ``converge_eps`` exit needs the eager forward."""

    def fwd(a, b) -> torch.Tensor:
        return model(a, b, iters=iters)[1]

    return InferenceEngine(
        fwd, device=next(model.parameters()).device, batch=infer.batch,
        prefetch_depth=infer.prefetch, max_executables=infer.max_executables,
        deadline_s=infer.deadline_s, capture=model.config.converge_eps == 0,
        # what a graph bakes in besides its shapes: the model (its weights'
        # addresses) and the iteration count
        graph_key=(id(model), repr(model.config), int(iters)))


def make_serving(model: RAFTStereo, iters: int, infer: InferOptions):
    """``(engine, stream_fn)``: the plain engine and its ``stream``."""
    engine = make_engine(model, iters, infer)
    return engine, engine.stream


def _epe_image(forward, img1, img2) -> np.ndarray:
    """Run one padded forward; return the unpadded disparity [H, W]."""
    padder = InputPadder(img1[None].shape, divis_by=32)
    p1, p2 = padder.pad(img1[None], img2[None])
    disp = padder.unpad(forward(p1, p2))
    return disp[0, :, :, 0].cpu().numpy()


def _engine_predictions(model, iters: int, ds, infer: InferOptions
                        ) -> Tuple[InferenceEngine, Iterator[Tuple[int, np.ndarray, tuple]]]:
    """The batched path: ``(engine, iterator of (index, pred, (flow_gt,
    valid_gt)))``; the engine is returned so callers can read its stats.
    The dataset read is each request's lazy decode on the stager thread: a
    sample that fails to read becomes an error result, is logged and left
    out of the metrics, and the published summary counts it."""
    engine, stream = make_serving(model, iters, infer)
    gts: Dict[int, tuple] = {}

    def requests():
        for i in range(len(ds)):
            def decode(i=i):
                img1, img2, flow_gt, valid_gt = ds[i]
                gts[i] = (flow_gt, valid_gt)
                return img1, img2

            yield InferRequest(payload=i, inputs=decode)

    def results():
        try:
            for res in stream(requests()):
                if not res.ok:
                    logger.warning("request %s failed (%s: %s): excluded from metrics",
                                   res.payload, type(res.error).__name__, res.error)
                    gts.pop(res.payload, None)
                    continue
                yield res.payload, res.output[:, :, 0], gts.pop(res.payload)
        finally:
            infer_mod.publish_summary(engine.stats, label="evaluate")

    return engine, results()


def _iter_predictions(model, iters: int, ds, infer: Optional[InferOptions]
                      ) -> Iterator[Tuple[int, np.ndarray, tuple]]:
    """``(index, pred [H, W], (flow_gt, valid_gt))`` for every sample:
    ``infer=None`` runs the per-image path in index order, otherwise the
    engine streams in completion order (callers key on the index)."""
    if infer is None:
        forward = make_forward(model, iters)
        for i in range(len(ds)):
            img1, img2, flow_gt, valid_gt = ds[i]
            yield i, _epe_image(forward, img1, img2), (flow_gt, valid_gt)
        return
    yield from _engine_predictions(model, iters, ds, infer)[1]


def validate_eth3d(model, iters: int = 32, infer: Optional[InferOptions] = None
                   ) -> Dict[str, float]:
    """ETH3D training split: EPE and bad-1.0."""
    ds = datasets.ETH3D(aug_params=None)
    by_index = {}
    for i, pred, (flow_gt, valid_gt) in _iter_predictions(model, iters, ds, infer):
        epe = np.abs(pred - flow_gt[..., 0])
        val = valid_gt >= 0.5
        by_index[i] = (epe[val].mean(), (epe > 1.0)[val].mean())
        logger.info("ETH3D %d/%d EPE %.4f D1 %.4f", i + 1, len(ds), *by_index[i])
    if not by_index:
        return {"eth3d-epe": float("nan"), "eth3d-d1": float("nan")}
    epe_list = [by_index[i][0] for i in sorted(by_index)]
    out_list = [by_index[i][1] for i in sorted(by_index)]
    res = {"eth3d-epe": float(np.mean(epe_list)), "eth3d-d1": 100 * float(np.mean(out_list))}
    print("Validation ETH3D: EPE %f, D1 %f" % (res["eth3d-epe"], res["eth3d-d1"]))
    return res


def validate_kitti(model, iters: int = 32, infer: Optional[InferOptions] = None
                   ) -> Dict[str, float]:
    """KITTI-2015 training split: EPE, D1 (bad-3.0) and FPS. The per-image
    path's FPS is the reference's per-pair wall clock after a 50-image
    warm-up; the engine's is its throughput, capture time excluded."""
    ds = datasets.KITTI(aug_params=None)
    if infer is not None:
        by_index = {}
        t0 = time.perf_counter()
        engine, preds = _engine_predictions(model, iters, ds, infer)
        for i, pred, (flow_gt, valid_gt) in preds:
            epe = np.abs(pred - flow_gt[..., 0])
            val = valid_gt >= 0.5
            by_index[i] = (epe[val].mean(), (epe > 3.0)[val])
        wall = time.perf_counter() - t0
        if not by_index:
            return {"kitti-epe": float("nan"), "kitti-d1": float("nan")}
        res = {
            "kitti-epe": float(np.mean([by_index[i][0] for i in sorted(by_index)])),
            "kitti-d1": 100 * float(
                np.concatenate([by_index[i][1] for i in sorted(by_index)]).mean()),
        }
        serving = max(wall - engine.graphs.capture_s, 1e-9)
        res["kitti-fps"] = len(by_index) / serving
        print(f"Validation KITTI: EPE {res['kitti-epe']}, D1 {res['kitti-d1']}, "
              f"{res['kitti-fps']:.2f}-FPS engine throughput ({len(by_index)} images in "
              f"{serving:.3f}s, capture excluded)")
        return res

    forward = make_forward(model, iters)
    epe_list, out_list, elapsed = [], [], []
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds[i]
        padder = InputPadder(img1[None].shape, divis_by=32)
        p1, p2 = padder.pad(img1[None], img2[None])
        start = time.time()
        disp = forward(p1, p2)
        if disp.is_cuda:
            torch.cuda.synchronize()
        end = time.time()
        if i > 50:
            elapsed.append(end - start)
        pred = padder.unpad(disp)[0, :, :, 0].cpu().numpy()
        epe = np.abs(pred - flow_gt[..., 0])
        val = valid_gt >= 0.5
        epe_list.append(epe[val].mean())
        out_list.append((epe > 3.0)[val])
    if not epe_list:
        return {"kitti-epe": float("nan"), "kitti-d1": float("nan")}
    res = {
        "kitti-epe": float(np.mean(epe_list)),
        "kitti-d1": 100 * float(np.concatenate(out_list).mean()),
    }
    if elapsed:
        rt = float(np.mean(elapsed))
        res["kitti-fps"] = 1.0 / rt
        print(f"Validation KITTI: EPE {res['kitti-epe']}, D1 {res['kitti-d1']}, "
              f"{1 / rt:.2f}-FPS ({rt:.3f}s)")
    return res


def validate_things(model, iters: int = 32, infer: Optional[InferOptions] = None
                    ) -> Dict[str, float]:
    """FlyingThings3D TEST split: EPE and bad-1.0 under the |disp| < 192 mask."""
    ds = datasets.SceneFlowDatasets(dstype="frames_finalpass", things_test=True)
    by_index = {}
    for i, pred, (flow_gt, valid_gt) in _iter_predictions(model, iters, ds, infer):
        epe = np.abs(pred - flow_gt[..., 0])
        val = (valid_gt >= 0.5) & (np.abs(flow_gt[..., 0]) < 192)
        by_index[i] = (epe[val].mean(), (epe > 1.0)[val])
    if not by_index:
        return {"things-epe": float("nan"), "things-d1": float("nan")}
    res = {
        "things-epe": float(np.mean([by_index[i][0] for i in sorted(by_index)])),
        "things-d1": 100 * float(
            np.concatenate([by_index[i][1] for i in sorted(by_index)]).mean()),
    }
    print("Validation FlyingThings: %f, %f" % (res["things-epe"], res["things-d1"]))
    return res


def validate_middlebury(model, iters: int = 32, split: str = "F",
                        infer: Optional[InferOptions] = None) -> Dict[str, float]:
    """Middlebury-V3: EPE and bad-2.0."""
    ds = datasets.Middlebury(aug_params=None, split=split)
    by_index = {}
    for i, pred, (flow_gt, valid_gt) in _iter_predictions(model, iters, ds, infer):
        epe = np.abs(pred - flow_gt[..., 0])
        val = (valid_gt.reshape(-1) >= -0.5) & (flow_gt[..., 0].reshape(-1) > -1000)
        epe_f = epe.reshape(-1)
        by_index[i] = (epe_f[val].mean(), (epe_f > 2.0)[val].mean())
        logger.info("Middlebury %d/%d EPE %.4f D1 %.4f", i + 1, len(ds), *by_index[i])
    if not by_index:
        return {f"middlebury{split}-epe": float("nan"), f"middlebury{split}-d1": float("nan")}
    res = {
        f"middlebury{split}-epe": float(np.mean([by_index[i][0] for i in sorted(by_index)])),
        f"middlebury{split}-d1": 100 * float(
            np.mean([by_index[i][1] for i in sorted(by_index)])),
    }
    print(f"Validation Middlebury{split}: EPE {res[f'middlebury{split}-epe']}, "
          f"D1 {res[f'middlebury{split}-d1']}")
    return res


VALIDATORS = {
    "eth3d": validate_eth3d,
    "kitti": validate_kitti,
    "things": validate_things,
    "middlebury_F": lambda m, iters=32, infer=None: validate_middlebury(m, iters, "F", infer),
    "middlebury_H": lambda m, iters=32, infer=None: validate_middlebury(m, iters, "H", infer),
    "middlebury_Q": lambda m, iters=32, infer=None: validate_middlebury(m, iters, "Q", infer),
}


def add_model_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The architecture flags of the JAX package's ``add_model_args``."""
    parser.add_argument("--preset", choices=list(PRESET_FLAGS), default=None,
                        help="named model preset; explicit flags override")
    parser.add_argument("--restore_ckpt", default=None, help="reference checkpoint (.pth)")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--hidden_dims", nargs="+", type=int, default=[128] * 3)
    parser.add_argument("--corr_implementation", choices=list(CORR_IMPLEMENTATIONS), default="reg")
    parser.add_argument("--shared_backbone", action="store_true")
    parser.add_argument("--corr_levels", type=int, default=4)
    parser.add_argument("--corr_radius", type=int, default=4)
    parser.add_argument("--n_downsample", type=int, default=2)
    parser.add_argument("--context_norm", default="batch",
                        choices=["group", "batch", "instance", "none"])
    parser.add_argument("--slow_fast_gru", action="store_true")
    parser.add_argument("--n_gru_layers", type=int, default=3)
    parser.add_argument(
        "--fused_update", action="store_true",
        help="run each test-mode refinement step but the last as one fused step "
        "(correlation lookup, motion encoder, finest ConvGRU and flow head); on "
        "CUDA the hand-written kernel runs or the call raises, on the CPU its "
        "plain PyTorch version runs",
    )
    return parser


def main(argv=None, device=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    add_infer_args(parser)
    parser.add_argument("--dataset", required=True, choices=list(VALIDATORS),
                        help="validation set")
    apply_preset_defaults(parser, argv)
    args = parser.parse_args(argv)
    # The reference eval autocasts iff the corr implementation is spelled
    # *_cuda: those command lines run the whole forward in half precision.
    args.mixed_precision = args.mixed_precision or args.corr_implementation.endswith("_cuda")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    infer_mod.reset_summary()
    model = load_model(args, device=device)
    res = VALIDATORS[args.dataset](model, iters=args.valid_iters,
                                   infer=options_from_args(args))
    # metrics cover completed pairs only; exit non-zero past the budget
    infer_mod.enforce_failure_budget(args.max_failed_frac)
    return res


if __name__ == "__main__":
    main()
