"""Where one test-mode forward spends its time on the card.

    python -m raft_stereo_tpu_torch.profile_forward [--preset NAME] [--fused_update] [--packed]

Builds the preset's model (default raftstereo-middlebury; seeded random
weights), with ``--fused_update`` its fused refinement path and with
``--packed`` the packed encoder stage (``models.extractor._ENABLE_PACKED``),
runs one 544x960 pair (the padded 540x960 shape) for the preset's
iterations once to warm up, then once under ``torch.profiler``. Prints one
JSON line: the forward's host-clock time, the summed device time and count
of its kernels, the device's busy share of the forward, and the kernels
that take the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from raft_stereo_tpu_torch.config import PRESET_FLAGS, PRESETS
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.models import extractor


def main(height: int = 544, width: int = 960, iters: Optional[int] = None, top: int = 15,
         fused_update: bool = False, preset: str = "raftstereo-middlebury",
         packed: bool = False) -> dict:
    cfg = dataclasses.replace(PRESETS[preset], fused_update=fused_update)
    iters = iters or PRESET_FLAGS[preset].get("valid_iters", 32)
    model = load_model(cfg, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((1, height, width, 3), generator=g, device="cuda") * 255
    b = torch.rand((1, height, width, 3), generator=g, device="cuda") * 255
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = packed
    try:
        model(a, b, iters=iters)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model(a, b, iters=iters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        extractor._ENABLE_PACKED = saved
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    res = {
        "device": torch.cuda.get_device_name(0), "preset": preset,
        "shape": [height, width], "iters": iters, "fused_update": fused_update,
        "packed_stage": packed,
        "forward_ms": wall * 1e3,
        "device_kernel_ms": device_us / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "device_busy_share": device_us / 1e6 / wall,
        "top_kernels": [
            {"name": e.key[:90], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in kernels[:top]
        ],
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=list(PRESETS), default="raftstereo-middlebury")
    parser.add_argument("--fused_update", action="store_true")
    parser.add_argument("--packed", action="store_true",
                        help="run the packed encoder stage where its gate passes")
    args = parser.parse_args()
    main(fused_update=args.fused_update, preset=args.preset, packed=args.packed)
