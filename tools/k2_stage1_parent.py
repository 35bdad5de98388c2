"""Times K2's launches, its first (stage 1: the lookup with convc1 and
convf1) and its last (stage 7: the flow head's conv2) picked out, of this
checkout against another commit's, on one card, in one process.

    git archive <commit> raft_stereo_tpu_torch/csrc | tar -x -C build/other
    python3 tools/k2_stage1_parent.py --other_csrc build/other/raft_stereo_tpu_torch/csrc

Builds the other commit's ``csrc/fused_update.cu`` with nvcc. Its C entry
point is ``fused_update_step`` with this checkout's arguments (stage 1's
launch geometry among them, as since the commit that gave stage 1 one).
Then it runs one fused step at the slice shape (544x960 at 1/4, bf16, with
inp16) under torch.profiler with each library in turn: other, this
checkout, this checkout, other; once on chip_smoke.py's inputs, whose
disparities are drawn per pixel (uniform in [0, 0.6 W]), and once with the
same features and a smooth disparity field (a plane with a ripple, 0.3 W at
its mean), as a scene gives. Each run prints one JSON line with the device ms of every launch,
stages 1 and 7 picked out, and the whole step timed with CUDA events; then
the medians by library and the card's name and power limit as nvidia-smi
gives them.
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
    """The other library's step, bound with this wrapper's signature."""
    from raft_stereo_tpu_torch.ops import fused_update

    fn = ctypes.CDLL(str(so)).fused_update_step
    fn.argtypes = fused_update._kernel().step.argtypes
    fn.restype = ctypes.c_int
    return fused_update._Bound(fn, None, None)


def _pick(times, kernel):
    return next((v for k, v in times.items() if kernel in k), None)


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
                    res = {"tool": "k2_stage1_parent", "disparity": flow, "library": which,
                           "stage1_ms": _pick(times, "motion_in_kernel"),
                           "stage7_ms": _pick(times, "head_out_kernel"),
                           "step_ms": chip_smoke._time_ms(run, args.reps),
                           "device_ms_by_kernel": times}
                    print(json.dumps(res), flush=True)
                    runs.append(res)
        finally:
            fused_update._fn = None
    summary = {key: {f"{flow} {w}": statistics.median(
        r[key] for r in runs if r["library"] == w and r["disparity"] == flow)
        for flow in inputs for w in ("other", "this")}
        for key in ("stage1_ms", "stage7_ms", "step_ms")}
    print(json.dumps({"tool": "k2_stage1_parent", "median": summary}), flush=True)
    print(chip_smoke.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
