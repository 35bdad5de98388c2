"""Times K2's first launch (stage 1: the lookup with convc1 and convf1) of
this checkout against another commit's, on one card, in one process.

    git archive <commit> raft_stereo_tpu_torch/csrc | tar -x -C build/other
    python3 tools/k2_stage1_parent.py --other_csrc build/other/raft_stereo_tpu_torch/csrc

Builds the other commit's ``csrc/fused_update.cu`` with nvcc. Its C entry
point is ``fused_update_step`` as it was before stage 1 took a launch
geometry (the same arguments less seg, threads, dc and smem). Then it runs
one fused step at the slice shape (544x960 at 1/4, bf16, with inp16) under
torch.profiler with each library in turn: other, this checkout, this
checkout, other; once on chip_smoke.py's inputs, whose disparities are
drawn per pixel (uniform in [0, 0.6 W]), and once with the same features
and a smooth disparity field (a plane with a ripple, 0.3 W at its mean),
as a scene gives. Each run prints one JSON line with the device ms of
every launch, the stage-1 launch picked out, and the whole step timed with
CUDA events; then the card's name and power limit as nvidia-smi gives
them.
Needs a CUDA card; prints no result without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _bind_other(so: Path):
    """The other library's step, called with this wrapper's arguments."""
    from raft_stereo_tpu_torch.ops import fused_update

    fn = ctypes.CDLL(str(so)).fused_update_step
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   *[ctypes.c_int] * 8, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def step(*args):  # the wrapper passes stage 1's geometry before the stream
        return fn(*args[:12], args[-1])

    return fused_update._Bound(step, None)


ORDER = ("other", "this", "this", "other")


def _smooth_flow(H: int = 136, W: int = 240):
    """The x-flow of a smooth disparity field: a plane with a ripple,
    0.3 W at its mean, on the 1/64 grid of chip_smoke's inputs."""
    import torch

    y = torch.arange(H, device="cuda", dtype=torch.float32)[:, None]
    x = torch.arange(W, device="cuda", dtype=torch.float32)[None, :]
    disp = 0.3 * W + 0.1 * W * (x / W - 0.5) + 0.05 * W * torch.sin(y / 9.0 + x / 23.0)
    return -(torch.round(disp * 64.0) / 64.0)[None]


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other_csrc", type=Path, required=True,
                        help="csrc/ directory of the commit to compare with")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_stage1_parent: no CUDA device")

    import chip_smoke
    from raft_stereo_tpu_torch.ops import _build, fused_update

    dtype = torch.bfloat16
    with tempfile.TemporaryDirectory(prefix="k2_other_") as tmp:
        so = Path(tmp) / "fused_update_other.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(args.other_csrc),
                        "-o", str(so), str(args.other_csrc / "fused_update.cu")],
                       check=True, capture_output=True, text=True)
        libs = {"other": _bind_other(so), "this": fused_update._kernel()}
        _, random_args = chip_smoke._fused_inputs(1, 136, 240, 256, 4, 4, True, dtype,
                                                  seed=chip_smoke.SEED + 10)
        inputs = {"random": random_args, "smooth": (*random_args[:3], _smooth_flow(),
                                                    *random_args[4:])}
        runs = []
        try:
            with chip_smoke._fp32_checks():
                for flow, which in [(f, w) for f in inputs for w in ORDER]:
                    fused_update._fn = libs[which]
                    step_args = inputs[flow]

                    def run():
                        return fused_update.fused_refine_step(*step_args, compute_dtype=dtype)

                    times = chip_smoke._device_ms_by_kernel(run, args.reps)
                    stage1 = next((v for k, v in times.items() if "motion_in_kernel" in k), None)
                    res = {"tool": "k2_stage1_parent", "disparity": flow, "library": which,
                           "stage1_ms": stage1, "step_ms": chip_smoke._time_ms(run, args.reps),
                           "device_ms_by_kernel": times}
                    print(json.dumps(res), flush=True)
                    runs.append(res)
        finally:
            fused_update._fn = None
    summary = {f"{flow} {w}": statistics.median(
        r["stage1_ms"] for r in runs if r["library"] == w and r["disparity"] == flow)
        for flow in inputs for w in ("other", "this")}
    print(json.dumps({"tool": "k2_stage1_parent", "stage1_ms_median": summary}), flush=True)
    print(chip_smoke.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
