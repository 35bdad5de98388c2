"""Where one test-mode forward spends its time on the card.

    python -m raft_stereo_tpu_torch.profile_forward [--fused_update]

Builds the raftstereo-middlebury preset model (seeded random weights), with
``--fused_update`` its fused refinement path, runs one 544x960 pair (the
padded 540x960 shape) for 32 iterations once to warm up, then once under
``torch.profiler``. Prints one JSON line: the forward's
host-clock time, the summed device time and count of its kernels, the
device's busy share of the forward, and the kernels that take the most
device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.evaluate import load_model


def main(height: int = 544, width: int = 960, iters: int = 32, top: int = 15,
         fused_update: bool = False) -> dict:
    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], fused_update=fused_update)
    model = load_model(cfg, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((1, height, width, 3), generator=g, device="cuda") * 255
    b = torch.rand((1, height, width, 3), generator=g, device="cuda") * 255
    model(a, b, iters=iters)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model(a, b, iters=iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    res = {
        "device": torch.cuda.get_device_name(0),
        "shape": [height, width], "iters": iters, "fused_update": fused_update,
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
    parser.add_argument("--fused_update", action="store_true")
    main(fused_update=parser.parse_args().fused_update)
