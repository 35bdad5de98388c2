"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit; fails without a card;
  2. build: compiles every CUDA kernel of the port from ``csrc/``;
  3. kernel check: each kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it and at the Middlebury-F
     width, with timings and the card's bound for the same work;
  4. main path: ``raft_stereo_tpu_torch.demo.main`` with the
     raftstereo-middlebury preset (full width, 32 iterations, seeded random
     weights) on four synthetic 540x960 pairs; checks the outputs and that
     every lookup went through the kernel;
  5. path parity: one pair through the fp32 forward (TF32 off), every
     lookup held to the plain version on the same inputs, and the whole
     forward with the kernel held to the forward with the plain lookup.
Then the ``kernels`` line, the ``nvidia-smi`` name/power line and, last,
``{"ok": true, "device": ...}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

ALT_TOL = 1e-4  # fp32 sum-order differences between kernel and plain version
PARITY_ATOL_LOWRES = 2e-3
PARITY_ATOL_UP = 5e-3
PARITY_RTOL = 1e-4
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "smi": smi_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit({"phase": "device", **dev})
    return dev


def phase_build():
    from raft_stereo_tpu_torch.ops import _build
    from raft_stereo_tpu_torch.ops.alt_corr import KERNEL

    t0 = time.perf_counter()
    _build.build([KERNEL])
    seconds = time.perf_counter() - t0
    for line in _build.BUILD_INFO[KERNEL]["ptxas"]:
        print(line, flush=True)
    emit({"phase": "build", "kernels": [KERNEL], "seconds": seconds,
          "nvcc_seconds": {k: v["seconds"] for k, v in _build.BUILD_INFO.items()}})


def _alt_inputs(B, H, W1, D, levels, seed):
    """Seeded features, pooled pyramid and coordinates that cover
    out-of-range windows, exact integers and both image edges."""
    import torch

    from raft_stereo_tpu_torch.ops.corr import pool_fmap_pyramid

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn((B, H, W1, D), generator=g, device="cuda")
    f2 = torch.randn((B, H, W1, D), generator=g, device="cuda")
    pyr = pool_fmap_pyramid(f2, levels)  # strided views, as in the model
    x = torch.arange(W1, device="cuda", dtype=torch.float32).expand(B, H, W1)
    disp = torch.rand((B, H, W1), generator=g, device="cuda") * (0.6 * W1)
    coords = (x - disp + 8.0).clone()
    coords.view(-1)[::7] = torch.round(coords.view(-1)[::7])  # exact integers
    coords.view(-1)[3::97] = -1.0e3  # window wholly left of the image
    coords.view(-1)[5::89] = 4.0 * W1  # wholly right
    coords.view(-1)[11::53] = -2.5  # partly outside
    # On a 1/64-pixel grid x/2^l + k is exact in fp32, so the plain
    # version's per-tap positions and the kernel's one frac agree and the
    # comparison sees only summation order. (Off the grid the per-tap
    # rounding alone moves a tap by up to ulp(x)·|c[k+1]−c[k]|/√D.)
    return f1, pyr, torch.round(coords * 64.0) / 64.0


def _alt_bound(f1, pyr, coords, radius):
    """Least time for one lookup on the card: each input read once and the
    output written once, against the dot products this data needs."""
    import torch

    K = 2 * radius + 1
    L = len(pyr)
    B, H, W1, D = f1.shape
    n_bytes = 4 * (f1.numel() + sum(p.numel() for p in pyr) + coords.numel() + B * H * W1 * L * K)
    valid_rows = 0
    j = torch.arange(2 * radius + 2, device=coords.device)
    for lvl, p in enumerate(pyr):
        base = torch.floor(coords / 2 ** lvl).clamp(-1e6, 1e6).long() - radius
        pos = base[..., None] + j
        valid_rows += int(((pos >= 0) & (pos < p.shape[2])).sum())
    flops = 2 * D * valid_rows + 4 * B * H * W1 * L * K
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_ms(fn, reps, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_check():
    """K1 against its plain version on the card. The first case is the
    main path's shape (544x960 padded input at 1/4 resolution)."""
    import torch

    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    cases = [
        ("slice_544x960", (1, 136, 240, 256), 4, 4, 50, 5),
        ("middlebury_F_1984x2880", (1, 496, 720, 256), 4, 4, 50, 2),
        ("odd_widths_b2", (2, 8, 123, 256), 4, 4, 10, 2),
        ("d64_r2", (1, 6, 77, 64), 3, 2, 10, 2),
    ]
    checks = []
    saved = alt_corr.LAUNCHES
    for name, (B, H, W1, D), levels, radius, reps, plain_reps in cases:
        f1, pyr, coords = _alt_inputs(B, H, W1, D, levels, seed=SEED + len(checks))
        got = alt_corr.corr_lookup_alt(f1, pyr, coords, radius)
        torch.cuda.synchronize()
        want = corr_lookup_alt_plain(f1, pyr, coords, radius)
        err = float((got - want).abs().max())
        if not math.isfinite(err) or err > ALT_TOL:
            raise AssertionError(f"alt_corr {name}: max abs err {err} > {ALT_TOL}")
        ms = _time_ms(lambda: alt_corr.corr_lookup_alt(f1, pyr, coords, radius), reps)
        plain_ms = _time_ms(lambda: corr_lookup_alt_plain(f1, pyr, coords, radius),
                            plain_reps, warmup=1)
        bound = _alt_bound(f1, pyr, coords, radius)
        checks.append({"case": name, "shape": [B, H, W1, D], "levels": levels,
                       "radius": radius, "widths": [p.shape[2] for p in pyr],
                       "max_abs_err": err, "tol": ALT_TOL, "ms": ms,
                       "plain_ms": plain_ms, **bound})
        del f1, pyr, coords, got, want
        torch.cuda.empty_cache()
    alt_corr.LAUNCHES = saved  # comparison launches do not count
    emit({"phase": "kernel_check", "kernel": "alt_corr", "checks": checks})
    return checks


def _write_pairs(root: Path, n: int, H: int = 540, W: int = 960, seed: int = SEED):
    """``n`` seeded synthetic stereo pairs: a smoothed random texture and a
    copy shifted by a per-pair disparity, as PNGs in ``root/pairK/im{0,1}``."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    pad = 64
    for k in range(n):
        tex = rng.rand(H, W + 2 * pad, 3)
        for axis in (0, 1):  # 5-tap box blur along each axis
            tex = sum(np.roll(tex, s, axis=axis) for s in range(-2, 3)) / 5.0
        tex = (tex * 255).astype(np.uint8)
        d = 8 + 12 * k
        left = tex[:, pad : pad + W]
        right = tex[:, pad + d : pad + d + W]  # right(x) = left(x + d)
        pair = root / f"pair{k}"
        pair.mkdir(parents=True)
        Image.fromarray(np.ascontiguousarray(left)).save(pair / "im0.png")
        Image.fromarray(np.ascontiguousarray(right)).save(pair / "im1.png")


def phase_main_path(tmp: Path, n_pairs: int = 4, iters: int = 32):
    """The port's demo entry point, raftstereo-middlebury preset."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import demo
    from raft_stereo_tpu_torch.ops import alt_corr

    data, out = tmp / "pairs", tmp / "out"
    _write_pairs(data, n_pairs)
    argv = ["--preset", "raftstereo-middlebury", "--valid_iters", str(iters),
            "--left_imgs", str(data / "*" / "im0.png"),
            "--right_imgs", str(data / "*" / "im1.png"),
            "--output_directory", str(out), "--save_numpy"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alt_corr.LAUNCHES = 0
    t0 = time.perf_counter()
    seconds = demo.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = alt_corr.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    if len(seconds) != n_pairs:
        raise AssertionError(f"demo served {len(seconds)} pairs, expected {n_pairs}")
    if launches != n_pairs * iters:
        raise AssertionError(f"alt_corr launched {launches} times, expected {n_pairs * iters}")
    for k in range(n_pairs):
        disp = np.load(out / f"pair{k}.npy")
        if disp.shape != (540, 960) or not np.isfinite(disp).all():
            raise AssertionError(f"pair{k}: disparity {disp.shape}, finite={np.isfinite(disp).all()}")
        if not (out / f"pair{k}.png").is_file():
            raise AssertionError(f"pair{k}.png missing")
    steady = seconds[1:] or seconds
    res = {
        "phase": "main_path", "entry": "raft_stereo_tpu_torch.demo.main",
        "preset": "raftstereo-middlebury", "pairs": n_pairs, "input": [540, 960],
        "padded": [544, 960], "iters": iters, "alt_corr_launches": launches,
        "first_pair_ms": seconds[0] * 1e3,
        "ms_per_pair": 1e3 * sum(steady) / len(steady),
        "pairs_per_s": len(steady) / sum(steady),
        "wall_s_with_model_build": wall,
        "max_memory_allocated_bytes": peak,
        "conv_dtype": "bfloat16 (mixed_precision)",
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(res)
    return res


def _ulp32(x: float) -> float:
    """Spacing of float32 values at magnitude |x| (at least 1)."""
    return 2.0 ** (math.frexp(max(abs(x), 1.0))[1] - 24)


def phase_parity(tmp: Path, iters: int = 32, iters_checked: int = 2):
    """The fp32 forward (TF32 off) on one pair, with the kernel and with the
    plain lookup, same weights.

    (a) Along the kernel forward's 32 iterations, every lookup is also run
    through the plain version on the same inputs and held to it. The plain
    version rounds x/2^l + k once per tap, the kernel forms one frac per
    level, so their positions differ by up to half an ulp of |x| + r; the
    tolerance is that shift times twice the largest difference between
    neighbouring taps, plus ALT_TOL for summation order.
    (b) The two whole forwards are held to PARITY_ATOL_* after
    ``iters_checked`` iterations (the second lookup is the first at
    fractional positions). The weights are random and a random update
    block does not contract, so the forwards' difference grows with every
    iteration; it is printed for 1, 2, 4 and 32 iterations.
    """
    import dataclasses

    import numpy as np
    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.demo import load_image
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain
    from raft_stereo_tpu_torch.ops.pad import InputPadder

    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False)
    model = load_model(cfg, device="cuda", seed=SEED)
    img1 = load_image(str(tmp / "pairs" / "pair0" / "im0.png"))
    img2 = load_image(str(tmp / "pairs" / "pair0" / "im1.png"))
    p1, p2 = InputPadder(img1.shape, divis_by=32).pad(img1, img2)
    a = torch.from_numpy(p1).cuda()
    b = torch.from_numpy(p2).cuda()
    kernel_lookup = alt_corr.corr_lookup_alt
    lookups = []

    def checked_lookup(fmap1, pyramid, coords_x, radius):
        got = kernel_lookup(fmap1, pyramid, coords_x, radius)
        want = corr_lookup_alt_plain(fmap1, pyramid, coords_x, radius)
        err = float((got - want).abs().max())
        taps = want.unflatten(-1, (len(pyramid), 2 * radius + 1))
        step = float(taps.diff(dim=-1).abs().max())
        # half an ulp of shift times twice the largest tap difference
        tol = ALT_TOL + _ulp32(float(coords_x.abs().max()) + radius) * step
        lookups.append({"err": err, "tol": tol})
        return got

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             alt_corr.LAUNCHES)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        alt_corr.corr_lookup_alt = checked_lookup
        model(a, b, iters=iters)
        for n in (1, iters_checked, 4, iters):
            if n in runs:
                continue
            alt_corr.corr_lookup_alt = kernel_lookup
            before = alt_corr.LAUNCHES
            low_k, up_k = model(a, b, iters=n)
            if alt_corr.LAUNCHES - before != n:
                raise AssertionError(f"kernel forward launched alt_corr "
                                     f"{alt_corr.LAUNCHES - before} times, expected {n}")
            alt_corr.corr_lookup_alt = corr_lookup_alt_plain
            low_p, up_p = model(a, b, iters=n)
            runs[n] = [t.cpu().numpy() for t in (low_k, low_p, up_k, up_p)]
    finally:
        alt_corr.corr_lookup_alt = kernel_lookup
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         alt_corr.LAUNCHES) = saved
    growth = {}
    for n, (lk, lp, uk, up) in runs.items():
        if not (np.isfinite(uk).all() and np.isfinite(up).all()):
            raise AssertionError(f"non-finite disparity in the parity forwards at {n} iterations")
        growth[str(n)] = {"max_abs_err_lowres": float(np.abs(lk - lp).max()),
                          "max_abs_err_up": float(np.abs(uk - up).max()),
                          "max_abs_disp": float(np.abs(up).max())}
    lk, lp, uk, up = runs[iters_checked]
    res = {"phase": "parity", "dtype": "float32", "cudnn_allow_tf32": False,
           "matmul_allow_tf32": False, "shape": list(uk.shape),
           "lookups_checked": len(lookups),
           "lookup_max_abs_err": max(x["err"] for x in lookups),
           "lookup_min_tol": min(x["tol"] for x in lookups),
           "lookup_worst_err_over_tol": max(x["err"] / x["tol"] for x in lookups),
           "iters_checked": iters_checked, **growth[str(iters_checked)],
           "by_iters": growth, "atol_lowres": PARITY_ATOL_LOWRES,
           "atol_up": PARITY_ATOL_UP, "rtol": PARITY_RTOL}
    emit(res)
    if len(lookups) != iters:
        raise AssertionError(f"{len(lookups)} lookups checked, expected {iters}")
    bad = [i for i, x in enumerate(lookups) if not x["err"] <= x["tol"]]
    if bad:
        raise AssertionError(f"alt_corr disagrees with the plain lookup at iterations {bad}")
    np.testing.assert_allclose(lk, lp, atol=PARITY_ATOL_LOWRES, rtol=PARITY_RTOL)
    np.testing.assert_allclose(uk, up, atol=PARITY_ATOL_UP, rtol=PARITY_RTOL)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import raft_stereo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = phase_device()
    phase_build()
    checks = phase_kernel_check()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_res = phase_main_path(Path(tmp))
        phase_parity(Path(tmp))
    slice_check = checks[0]
    emit({"kernels": [{
        "name": "alt_corr",
        "route": "cuda",
        "source": "raft_stereo_tpu_torch/csrc/alt_corr.cu",
        "replaces": "raft_stereo_tpu/ops/pallas_corr.py:67",
        "launches": main_res["alt_corr_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "tol": ALT_TOL,
        "ms": slice_check["ms"],
        "plain_ms": slice_check["plain_ms"],
        "bound_ms": slice_check["bound_ms"],
        "bound_by": slice_check["bound_by"],
        "library_ms": None,
        "checks": checks,
    }]})
    print(dev["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
