"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit; fails without a card;
  2. build: compiles every CUDA kernel of the port from ``csrc/``, one
     ``nvcc`` each, all started together, and reports what ``-Xptxas -v``
     says of K1's kernels and of K2's and K3's wgmma kernels (registers,
     shared memory, spills, the compiler's notes);
  3. kernel checks: each kernel against its plain PyTorch version on the
     card (TF32 off), at the shapes the main paths give it and at a few
     ragged ones, with timings and the card's bound for the same work:
     K1 (alt lookup, also at the Middlebury-F width, the realtime shape
     and rows of three ragged segments, each with the chunk of channels
     and the shared memory its launch takes) and K2 (fused step,
     fp32 and bf16, with and without inp16, beside the unfused port step
     at the same shape; on the slice case each of its 7 launches timed
     under torch.profiler, each beside its own bound, each conv launch
     beside cuDNN's conv at its channel counts, stage 1 with its launch
     geometry, stage 7 beside cuDNN's bare 256 -> 1 conv); faults planted in copies of K2's source must fail the bf16
     check, those in stage 1 the stage-1 check too; K2's stage 1 alone
     (``fused_update.motion_in``: the lookup, convc1 and convf1) against
     its plain version, bf16 and fp32, at the slice shape, ragged rows, the
     engine's batch-4 shapes and the Middlebury-F width, each with its time,
     bound and geometry (``k2_stage1_check``); K2's stage 7 alone
     (``fused_update.head_out``: the flow head's conv2, x channel) against
     its plain version, bf16 and fp32, at the same shapes and a tile larger
     than the image, two calls bitwise equal, each case beside cuDNN's
     bare 256 -> 1 conv (``k2_stage7_check``; K2's stage-7 faults must fail
     it too); K3 (the packed stage's 3x3x64 conv,
     fp32 and bf16, with and without its prologue, beside cuDNN's conv at
     the same shape), whose planted faults must fail the bf16 check too;
  4. main path: ``raft_stereo_tpu_torch.demo.main --per_image`` with the
     raftstereo-middlebury preset (full width, 32 iterations, seeded random
     weights) on four synthetic 540x960 pairs, the forward captured once as
     a CUDA graph and replayed for each pair; checks the outputs and that
     every lookup went through K1 (launches at capture x replays; the
     wrapper counters count the warm-up's and the capture's);
  5. main path, fused: the same with ``--fused_update``; every unmasked
     step goes through K2 (4 x 31) and the masked one's lookup through K1
     (4 x 1);
  6. main path, realtime: the raftstereo-realtime preset (7 iterations)
     on the same pairs, with the packed encoder stage off (4 x 7 K1
     launches, no K3) and on (also 4 x 4 K3 launches: layer1's convs on the
     stacked pair);
     then ``make_forward`` at batch 1 and 544x960, eager against captured
     in the same run for the slice-1 and realtime cells (``captured_forward``);
     the engine paths: ``demo.main`` on its default path, the batched engine
     at batch 4, over 6 pairs at 540x960 and 3 at 480x640 (two buckets, a
     partial batch in each), with the raftstereo-middlebury preset, with
     ``--fused_update`` and with the realtime preset and the packed stage
     (``engine_path*``: pairs/s, device ms a pair, capture seconds, replays,
     peak memory, launches; the served batch against an eager run of it,
     bitwise, and batched against per-image disparities); and
     ``evaluate.main --dataset eth3d`` on a synthetic ETH3D tree through the
     engine and ``--per_image`` (``evaluate_eth3d``); the engine's fault
     tolerance on the realtime-packed engine cell (``engine_faults``: a
     clean run, then one fresh engine for each of the four injectors, a
     failed decode, a capture that fails once and one that always fails,
     an OOM at batch 4, a hung device wait; each run's counts as its
     injector implies, the per-image path's K1 and K3 launches counted,
     every completed output bitwise a clean run's at the same effective
     batch size; then three captures that break midway, planted in the
     forward while the second bucket's graph is captured, a raise, a host
     read-back that invalidates the capture and a real allocator OOM: the
     first two retried, the OOM halved, the shared graph pool kept, every
     output bitwise the clean run's), the OOM halving under a real
     allocator limit set halfway between the batch-4 and batch-2 peaks
     (``engine_oom_real``), and the engine's pairs/s with and without a
     telemetry sink over streams of 270 pairs (``telemetry_cost``, by
     ``tools/engine_overhead.py``);
  7. path parity: one pair through the fp32 forward (TF32 off), every
     lookup held to the plain version on the same inputs, and the whole
     forward with the kernel held to the forward with the plain lookup;
  8. fused parity: the fp32 and the bf16 forward with ``fused_update``,
     every K2 step held to the plain step on the same inputs, and the fp32
     fused forward held to the unfused one;
  9. early exit: the fused model with a ``converge_eps`` picked from the
     per-step deltas of phase 8, which must stop where they say;
 10. packed parity: the realtime forward with the packed stage, fp32 and
     bf16, every K3 call held to the plain version on the same inputs, and
     the fp32 forward held to the one without the stage;
 11. training: K1 and K3 through their autograd Functions against the
     plain versions' autograd at the training shapes (``train_grad_check``:
     K1 [8, 80, 180, 256], K3 at the realtime stem [16, 160, 360, 64] fp32
     and bf16; a dropped level scale planted in K1's backward must fail;
     K2 at the slice shape with inp16, bf16 and fp32, its gradients with
     the kernel forward bitwise the plain autograd's, its backward timed);
     one fp32 train step with K1 against the step with the plain lookup
     (``train_step_check``, the same planted fault must fail);
     ``raft_stereo_tpu_torch.train.main`` on a synthetic FlyingThings3D
     TRAIN tree (16 pairs at 540x960) with the SceneFlow recipe (raftstereo,
     bf16, batch 8, 320x720, 22 iterations) for 6 steps (``train_path``,
     the ``reg`` lookup) and with ``--corr_implementation alt`` for 4
     (``train_path_alt``: K1 steps x 22 x 2 times, one more step profiled);
     SIGTERM at step 2, then ``--resume auto`` to step 4 (``train_resume``,
     batch 2, 4 iterations; the restored state held bitwise to the saved);
     ``train --multihost`` through ``python -m torch.distributed.run`` at
     world 1 on NCCL with the alt recipe (``ddp_path``: DDP, K1 steps x 44
     from the child's log, s/step beside ``train_path_alt``'s), then two
     gloo ranks sharing the card (``python3 chip_smoke.py ddp-rank R DIR``)
     against one process at global batch 8 (``DDP_PARITY``), the ranks
     bitwise equal, a planted per-rank mean failing;
     then ``evaluate.main --telemetry_dir`` and ``train.main --telemetry
     --profile_steps 2:3`` (3 steps), each run directory's events.jsonl,
     heartbeat.json (the card's memory in it), metrics.prom and
     trace_host.json parsed, every event declared in ``EVENT_SCHEMA``, and
     ``tools/run_report.py`` run on it (``telemetry_runs``).
     The training phases run in a temp directory.
 12. serving, on the captured engine: the continuous-batching scheduler
     over the raftstereo-middlebury batch-4 engine (``sched_path``: the
     FIFO stream bitwise the plain engine, an interleaved stream with
     deadlines and priorities, per item bitwise, its dispatch order, a
     trickle of the rare bucket flushed by ``max_wait``, pairs/s of both
     over 36-pair streams); shedding, the drain within and past its bound
     and ``RAFT_FI_SCHED_STALL`` on the realtime-packed engine
     (``sched_lifecycle``); ``demo.main --serve_video --adaptive_iters``
     on 8 frames of one moving 540x960 scene, with the convergence exit
     (K1's eager launches = the frames' iterations) and without it (one
     three-input graph, replay bitwise eager), and ``RAFT_FI_WARM_POISON``
     on frame 3 (``video_path``); ``update_variables`` replaying a fresh
     engine's outputs bitwise with no new capture; ``evaluate.main --sched
     --canary_every 4 --golden_dir`` twice and with goldens moved one pixel
     (``quality_canary``: capture, pass, fail and latch); SIGUSR2 during a
     scheduled video serve (``blackbox``: the dump's providers and thread
     roles).
 13. the MADNet2 family (no kernel of its own; each phase checks that K1-K3
     launch 0 times): ``evaluate_mad.main`` on a synthetic FlyingThings3D
     TEST tree (8 pairs at 540x960) through the captured engine at batch 4
     and ``--per_image``, for MADNet2 fp32, ``--mixed_precision`` and
     ``--fusion`` (``mad_eval``: metrics, pairs/s, device ms a pair,
     captures, replays, peak memory, batched against per-image disparities,
     one batch's replay bitwise its eager forward); MADNet2 and
     MADNet2Fusion on the card against the CPU at 384x1280, fp32
     (``mad_parity``); ``serve_adaptive.main`` at KITTI's 375x1242 on a
     shifted synthetic stream, adapting and ``--no_adapt`` over 64 requests,
     ``RAFT_FI_ADAPT_NAN`` (rollback), ``RAFT_FI_ADAPT_REGRESS`` (frozen)
     and ``--sched`` (``mad_adapt_serve``: proxy trends, ms a step, pairs/s,
     one capture however many ``update_variables``); ``train_mad.main`` at
     the JAX defaults for 6 steps and ``--adapt mad`` over 8 frames
     (``mad_train``).
 14. the serving composition (``runtime/tiers.py``, ``runtime/controller.py``,
     ``runtime/debug_server.py``): ``evaluate --tier quality`` against the
     untiered run on the synthetic ETH3D tree (raftstereo-middlebury, 32
     iterations, batch 4: metrics and every disparity bitwise) and ``--tier
     fast`` (MADNet2, no kernel) (``tier_path``); ``evaluate --cascade``
     (raftstereo-realtime, 7 iterations) accepting all, escalating all and
     at the default bar, against each tier alone, bitwise, then the cascade
     and each tier alone held in this process over 256 in-memory requests
     (pairs/s, device ms a pair per tier, the share escalated)
     (``cascade_path``); ``evaluate --adaptive_iters --iter_tiers 7,32``
     and a stream with every other request under a 0.5 s deadline, each
     served by the tier ``IterTierPolicy`` names, bitwise that tier's plain
     engine (``iter_tiers_path``); ``serve_adaptive --cascade --controller
     --slo_p95_ms --debug_port 0`` at 375x1242 under a burst and a calm
     tail: the ladder degrades in order and promotes back after the dwell,
     every request resolves once, the debug endpoints answer while it
     serves (``controller_path``). Every tier engine captures each key
     once, whichever tier captured while another served.
 15. the replica fleet (``runtime/fleet.py``, ``serve_fleet.py``), MADNet2
     at 375x1242, batch 2, each worker process capturing its own graph on
     the one card (``fleet_path``): 96 requests through 2 hosts bitwise a
     single host in this process, no failover; host 0 SIGKILLed a third of
     the way in, every payload resolved once; ``serve_fleet
     --rolling_restart_after 24`` with no failed request; ``--source video``
     sessions pinned, the router's own process holding no CUDA context;
     pairs/s at 1 and 2 hosts, start-up seconds, device memory a worker and
     the wire's ms a frame on each side, recorded. Launches not counted (other
     processes; MADNet2 runs none of K1-K3).
 16. the spatial tier (``models/raft_stereo_spatial.py``,
     ``parallel/spatial.py``, ``runtime/tiers.py::SpatialServer``), before
     the fleet, with the raftstereo-middlebury preset and the slabs on
     ``[cuda:0] * k`` (``spatial_path``): the sharded forward against the
     unsharded one at 544x960 (bf16 at one iteration within
     ENGINE_PER_IMAGE_TOL, which a planted conv halo one row short must
     exceed; fp32 at two iterations, unfused and fused, within
     PARITY_ATOL_*, which K2 on slabs one row short must exceed), K1's
     launches at 32 iterations (32·k a pair), K2's in the fused variant (one
     a shard), a ``SpatialServer`` stream routing the 992x1440 pairs past a
     1,000,000-pixel bar (each output bitwise its tier's engine's),
     ``evaluate --spatial_threshold``, and the 1024x1440 pair's device ms
     and peak memory at k = 1, 2, 4; the packed encoder stage per slab
     (raftstereo-realtime, K3 4·k launches a forward) against the unsharded
     packed forward (bf16 at one iteration, fp32 at two), which K3 on slabs
     with no halo row must exceed. ``python3 chip_smoke.py spatial`` runs
     the device, build, K1 check and this phase alone.
 17. the graph store (``runtime/aot_store.py``, ``--aot_dir``), after the
     spatial tier (``aot_path``): ``evaluate --dataset eth3d``
     (raftstereo-middlebury, K1), ``serve_adaptive --cascade`` (MADNet2 and
     the 8-iteration raftstereo at 375x1242) and ``serve_fleet`` (2 MADNet2
     workers), each run twice as a child process (``python3 chip_smoke.py
     aot-child CLI OUT ARGV...``) on one fresh store: each second run
     prewarms every key the first committed (``aot_store_hit``, zero
     ``bucket_compile``) and its result and every output are bitwise the
     first run's; engine build seconds, first-request latency cold and
     warm, the fleet's launch-to-healthy seconds and the evaluate
     children's K1 launches recorded.
Then the run's total seconds, the ``kernels`` line, the ``nvidia-smi`` name/power line and, last,
``{"ok": true, "device": ...}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, bf16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

ALT_TOL = 1e-4  # fp32 sum-order differences between kernel and plain version
PARITY_ATOL_LOWRES = 2e-3
PARITY_ATOL_UP = 5e-3
PARITY_RTOL = 1e-4
# K2 against its plain step. fp32: summation order only, at coordinates on
# a 1/64 grid; h' absolute (twice the 4.7e-5 measured at the slice shape,
# where the GRU sums run over 3456 products), delta relative to its scale
# (tests/test_fused_update.py's 2e-4). bf16: both versions round at the
# same points, but fp32 sums in another order flip a few roundings of
# cor/flo/cf2/m, and each flip moves h' and delta nearby. Those values
# reach the hundreds (their bf16 ulp is 0.5-2), so a cluster of flips can
# move an h' element by a tenth while 99% of h' stays bit-equal. So h' is
# held to the share of its elements that differ at all, which a wrong
# kernel raises, and to a max that catches a local fault; delta to three
# bf16 ulps of its largest magnitude. On an H100 at the slice shape and
# along the preset's bf16 forward: at most 1.6% of h' differing, by at
# most 0.137; delta within 1.5 ulps (the WMMA convs); with the wgmma convs
# at most 1.22%, 0.145 and 1.6 ulps, so the limits stand. Each fault of
# K2_MUTANTS must fail.
K2_FP32_TOL = {"h": 1e-4, "delta_rel": 2e-4}
K2_BF16_TOL = {"h": 2.0 ** -2, "h_share": 0.03, "delta_ulps": 3.0}
# Faults planted in a copy of csrc/fused_update.cu, each of which the bf16
# check must catch: (name, source text, replacement).
K2_MUTANTS = (
    # the bf16 GRU convs read zeros for inp16's first 32 channels
    ("inp16_chunk_dropped",
     "const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;",
     "const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W"
     " && !(args.nseg == 3 && k.src == args.seg[2].ptr && k.ch + ch < 32);"),
    # stage 1 stages the fp32 flow for convf1 instead of its rounding to T
    ("flow_cast_skipped",
     "round_to<T>(__ldg(a.flow + src))", "__ldg(a.flow + src)"),
    # stage 1 never copies the last chunk of channels (it reads a stale one)
    ("last_chunk_unstaged", "if (ci + 1 < chunks) {", "if (ci + 2 < chunks) {"),
    # stage 1 stages each level's last position as zero
    ("level_row_short",
     "cp_async16(dst + r * DC + 4 * q, src + (long long)r * a.D + cc, valid);",
     "cp_async16(dst + r * DC + 4 * q, src + (long long)r * a.D + cc, valid && r + 1 < W2);"),
    # the z gate rounded to bf16 before the blend
    ("z_cast_added",
     "for (int e = 0; e < 8; ++e) zz[e] = sigmoid_fast(o[e] + g[e]);",
     "for (int e = 0; e < 8; ++e) zz[e] = round_to<bf16>(sigmoid_fast(o[e] + g[e]));"),
    # the bf16 3x3 convs read zeros for the image's top row (a local fault)
    ("top_row_dropped", "const bool inside = yy >= 0 &&", "const bool inside = yy >= 1 &&"),
    # stage 7 reads the tile's right halo column as zero
    ("right_halo_column_zero",
     "y < H && x >= 0 && x < W;", "y < H && x >= 0 && x < W && hx + 1 < kHaloCols;"),
    # stage 7 never loads a pixel's last channel vector (i = kVecs - 1)
    ("last_vector_unloaded",
     "for (int i = 0; i < kVecs; ++i) v[i].load(",
     "for (int i = 0; i + 1 < kVecs; ++i) v[i].load("),
    # stage 7 reads the halo rows below an image's last row from the next
    # image of the batch instead of zero
    ("next_image_halo_rows",
     "y >= 0 && y < H && x >= 0", "y >= 0 && (y < H || b + 1 < B) && x >= 0"),
    # stage 7's shift-add takes tap (kx, ky) for (ky, kx)
    ("shift_add_taps_transposed", "t[3 * ky + kx][", "t[3 * kx + ky]["),
)
# The faults of K2_MUTANTS planted in stage 1, which the stage-1 check must
# catch as well.
K2_STAGE1_FAULTS = ("flow_cast_skipped", "last_chunk_unstaged", "level_row_short")
# The bf16 cases that the faults run on: the main path's, where the bf16
# check must catch each fault, and the ragged rows of two images, where it
# must catch the faults of K2_RAGGED_FAULTS: one that only touches the
# pixels whose windows reach a level row's end (of which the main path's
# shape, with disparities of up to 0.6 W, has few) and one that only
# touches the last row of an image that another image follows (none in the
# main path's batch of 1).
K2_FAULT_CASES = ("slice_544x960_bf16", "ragged_b2_h37_w123_bf16")
K2_RAGGED_FAULTS = ("level_row_short", "next_image_halo_rows")
# The faults of K2_MUTANTS planted in stage 7, which the stage-7 check must
# catch as well.
K2_STAGE7_FAULTS = ("right_halo_column_zero", "last_vector_unloaded", "next_image_halo_rows",
                    "shift_add_taps_transposed")
# K2's first launch (stage 1: the lookup, convc1 and convf1) against
# reference_motion_in. fp32 (TF32 off): summation order only, held to
# K2_STAGE1_FP32_TOL times the output's scale (max(1, |plain| max)). bf16:
# both versions round the taps, cor and flo at the same points and the
# products of bf16 values are exact in fp32, so K3_BF16_TOL's method holds:
# an element differs by one bf16 ulp at its magnitude where the two fp32
# sums straddle a rounding boundary, plus the sums' own difference, a
# multiple of eps32 times S, the sum of its terms' magnitudes, where the
# sum cancels. A cor element also passes through its taps' rounding points:
# the lookup's fp32 sums, in another order, can put a tap on either side of
# its bf16 rounding, so each tap adds one bf16 ulp of the tap times its
# |weight| to the element's allowance. The share of elements that differ
# at all is held to 3x the largest share measured. On an H100 over the
# k2_stage1_check cases: fp32 within 1.3e-6 (tolerance 3e-3 to 1.7e-2 at
# these scales); bf16 at most 0.90 of an element's allowance, the sums'
# order never beyond the ulp and tap terms (order_ratio 0: sum_eps keeps
# K3's 32 for sums that cancel), and at most 7.0e-5 of the elements
# differing; over the gpu tests' inputs (tests/test_torch_port_cuda.py,
# 6 shapes x 3 seeds in bf16) at most 2.2e-4 (10 of 46,080 elements).
K2_STAGE1_FP32_TOL = 1e-4
K2_STAGE1_BF16_TOL = {"ulps": 1.0, "sum_eps": 32.0, "share": 6.5e-4}
# K2's last launch (stage 7: the flow head's conv2, x channel) against
# reference_head_out. delta is fp32 in both versions; in bf16 the products
# of bf16 values are exact in fp32, so the two differ in summation order
# only, and in fp32 (TF32 off) also in the products' roundings. Either is a
# multiple of eps32 = 2^-24 times S, the sum of the magnitudes of the
# element's terms (the conv of |fh1| with |kfh2|, plus |bfh2|, computed by
# the plain route), so each element is held to
# K2_STAGE7_TOL["sum_eps"]·eps32·S, K3's and stage 1's 32 to start with;
# "order_ratio" is the largest |got - plain| / (eps32·S) of a case.
K2_STAGE7_TOL = {"sum_eps": 32.0}
# K3 against its plain version. fp32: summation order only over 576
# products, held to K3_FP32_TOL times the output's scale (max(1, |plain|
# max)); measured on an H100 at the encoder shape: 1.5e-6 of the scale.
# bf16: kernel and plain round at the same points (the prologue after its
# multiply and its add, the output once), the products of bf16 values are
# exact in fp32, and the two fp32 sums differ only in order. So an element
# differs by one bf16 ulp where the two sums straddle a rounding boundary,
# plus the sums' own difference where the sum cancels to near zero (there
# a bf16 ulp is smaller than that difference). Two orders of one fp32 sum
# differ by a multiple of eps32 = 2^-24 times the sum of the magnitudes of
# its terms, S = sum |x·w| (the conv of |prologue(x)| with |w|, computed
# by the plain version), so each element is held to one ulp at its
# magnitude plus K3_BF16_TOL["sum_eps"]·eps32·S, its own allowance. The
# measured ratio, printed as "order_ratio", is (|got - plain| - ulp)/
# (eps32·S) in bf16 and |got - plain|/(eps32·S) in fp32; on an H100 over
# the four cases and along the realtime forward it reached 1.01 in bf16
# (where the ulp hides most of the sums' difference; the WMMA kernel and
# the wgmma one alike) and 9.84 in fp32 (another pair of orders), so
# sum_eps is 32, about 3x the larger. The share of elements that differ at
# all is held to 3x the largest share measured over the four bf16 cases
# (0.033%, both kernels). Each fault of K3_MUTANTS must fail.
K3_FP32_TOL = 2e-5
K3_BF16_TOL = {"ulps": 1.0, "sum_eps": 32.0, "share": 0.001}
# Faults planted in a copy of csrc/packed_conv.cu, each of which the bf16
# check must catch on the prologue case: (name, source text, replacement).
K3_MUTANTS = (
    # the prologue also maps the SAME padding's zeros (to relu(shift))
    ("prologue_on_padding",
     "if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // the SAME padding stays zero",
     "// the SAME padding mapped too"),
    # x·scale kept in fp32 up to the add: one rounding instead of two
    ("prologue_mul_rounding_skipped",
     "float u = round_to<bf16>(__fmul_rn(__bfloat162float(v[e]), __bfloat162float(sc[lane + e])));",
     "float u = __fmul_rn(__bfloat162float(v[e]), __bfloat162float(sc[lane + e]));"),
    # the halo's tensor map reads zeros for the image's bottom row (a local
    # fault: that row taken for padding)
    ("bottom_row_dropped",
     "const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)B};",
     "const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)a.W, (cuuint64_t)a.H - 1, (cuuint64_t)B};"),
)
# Layer1's 3x3 convs a forward of the packed stage: 2 blocks x 2 convs.
K3_PER_TRUNK = 4
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


def _demangle(names):
    """C++ names as c++filt gives them (unchanged where it is missing)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def ptxas_table(lines):
    """Each entry function of ``nvcc -Xptxas -v`` output: its registers,
    static shared memory, spill stores and loads, and the compiler's notes
    (e.g. wgmma serialisation)."""
    table, fn, notes = [], None, {}
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = {"function": m[1], "registers": None, "static_smem": 0,
                  "spill_stores": 0, "spill_loads": 0}
            table.append(fn)
            continue
        m = re.search(r"\((C\d+)\) .* in (?:the )?function '([^']+)'", ln)
        if m:  # ptxas may print a function's notes before its entry
            notes.setdefault(m[2], set()).add(m[1])
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            fn["spill_stores"], fn["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            fn["registers"] = int(m[1])
            sm = re.search(r"(\d+) bytes smem", ln)
            fn["static_smem"] = int(sm[1]) if sm else 0
    for f, name in zip(table, _demangle([f["function"] for f in table])):
        f["notes"] = sorted(notes.get(f["function"], ()))
        f["function"] = name
    return table


def phase_build():
    """Builds the kernels; the line gives, for each of K2's and K3's wgmma
    kernels, what ``-Xptxas -v`` says (registers, spills, notes) and the
    dynamic shared memory it launches with, the same for each of K1's and
    K2's stage-1 kernels (their shared memory is set per launch:
    kernel_check's ``smem_bytes``, k2_stage1_check's geometry), and for
    every kernel its register counts."""
    from raft_stereo_tpu_torch.experiments import packed_conv
    from raft_stereo_tpu_torch.ops import _build, alt_corr, fused_update

    kernels = [alt_corr.KERNEL, fused_update.KERNEL, packed_conv.KERNEL]
    t0 = time.perf_counter()
    _build.build(kernels)
    seconds = time.perf_counter() - t0
    regs, sm90 = {}, {}
    for name in kernels:
        table = ptxas_table(_build.BUILD_INFO[name]["ptxas"])
        regs[name] = sorted({f["registers"] for f in table if f["registers"] is not None})
        sm90[name] = [f for f in table if "_sm90" in f["function"]]
        for f in table:
            if f["spill_stores"] or f["spill_loads"]:
                print(f"spills: {f}", flush=True)
    lib_fused, lib_packed = _build.load(fused_update.KERNEL), _build.load(packed_conv.KERNEL)
    for f in sm90[fused_update.KERNEL]:
        m = re.search(r"conv_sm90<(\d+)", f["function"])
        f["dynamic_smem"] = lib_fused.fused_update_conv_smem(int(m[1])) if m else None
    for f in sm90[packed_conv.KERNEL]:
        f["dynamic_smem"] = lib_packed.packed_conv_smem()
    stage7 = [f for f in ptxas_table(_build.BUILD_INFO[fused_update.KERNEL]["ptxas"])
              if "head_out_kernel" in f["function"]]
    smem7 = fused_update.head_out_geometry(1, 1, 1).smem
    # ptxas reports the static shared memory rounded up (21,504 bytes for
    # 21,456 with CUDA 12.8)
    if any(not smem7 <= f["static_smem"] < smem7 + 1024 for f in stage7):
        raise AssertionError(f"stage 7's shared memory: ptxas {stage7}, the geometry {smem7}")
    emit({"phase": "build", "kernels": kernels, "seconds": seconds,
          "nvcc_seconds": {k: v["seconds"] for k, v in _build.BUILD_INFO.items()},
          "registers": regs, "wgmma_kernels": sm90,
          "alt_corr_kernels": ptxas_table(_build.BUILD_INFO[alt_corr.KERNEL]["ptxas"]),
          "k2_stage1_kernels": [
              f for f in ptxas_table(_build.BUILD_INFO[fused_update.KERNEL]["ptxas"])
              if "motion_in_kernel" in f["function"]],
          "k2_stage7_kernels": stage7})


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
    main path's shape (544x960 padded input at 1/4 resolution); the
    engine_* cases are the engine's, batch 4 in each of its two buckets, at
    1/4 (middlebury) and 1/8 (realtime) resolution."""
    import torch

    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    cases = [
        ("slice_544x960", (1, 136, 240, 256), 4, 4, 50, 5),
        ("middlebury_F_1984x2880", (1, 496, 720, 256), 4, 4, 50, 2),
        ("odd_widths_b2", (2, 8, 123, 256), 4, 4, 10, 2),
        ("d64_r2", (1, 6, 77, 64), 3, 2, 10, 2),
        ("realtime_544x960", (1, 68, 120, 256), 4, 4, 50, 5),
        # three ragged segments a row, a partial last chunk of channels
        ("ragged_3seg_b2_d100", (2, 6, 517, 100), 4, 4, 10, 2),
        ("engine_b4_544x960", (4, 136, 240, 256), 4, 4, 20, 2),
        ("engine_b4_480x640", (4, 120, 160, 256), 4, 4, 20, 2),
        ("engine_realtime_b4_544x960", (4, 68, 120, 256), 4, 4, 20, 2),
        ("engine_realtime_b4_480x640", (4, 60, 80, 256), 4, 4, 20, 2),
        # a slab of spatial_path's 544x960 pair split over two shards
        ("spatial_slab_k2_544x960", (1, 68, 240, 256), 4, 4, 50, 5),
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
        widths = [p.shape[2] for p in pyr]
        geo = alt_corr.launch_geometry(B * H, W1, widths, D)
        checks.append({"case": name, "shape": [B, H, W1, D], "levels": levels,
                       "radius": radius, "widths": widths, "dc": geo.dc, "smem_bytes": geo.smem,
                       "max_abs_err": err, "tol": ALT_TOL, "ms": ms,
                       "plain_ms": plain_ms, **bound})
        del f1, pyr, coords, got, want
        torch.cuda.empty_cache()
    alt_corr.LAUNCHES = saved  # comparison launches do not count
    emit({"phase": "kernel_check", "kernel": "alt_corr", "checks": checks})
    return checks


def _fused_inputs(B, H, W, D, levels, radius, with_inp, dtype, seed):
    """Seeded weights and step inputs at the scales the model gives them:
    the port's update block with its seeded init and small random biases,
    unit-variance features, disparities of up to 0.6 W on a 1/64 grid (so
    the lookup's positions are exact, as in K1's check), tanh states."""
    import torch

    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
    from raft_stereo_tpu_torch.ops import fused_update
    from raft_stereo_tpu_torch.ops.corr import pool_fmap_pyramid

    block = BasicMultiUpdateBlock((128, 128, 128), 3 if with_inp else 1, 2, levels, radius)
    init_weights(block, torch.Generator().manual_seed(seed))
    gb = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gb))
    block = block.cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    f1 = rnd(B, H, W, D)
    pyr = pool_fmap_pyramid(rnd(B, H, W, D), levels)
    flow = -torch.rand((B, H, W), generator=g, device="cuda") * (0.6 * W)
    flow = torch.round(flow * 64.0) / 64.0
    h = torch.tanh(rnd(B, H, W, 128)).to(dtype)
    inp = torch.tanh(rnd(B, H, W, 128)).to(dtype) if with_inp else None
    ctx = (0.5 * rnd(B, H, W, 384)).to(dtype)
    packed = fused_update.pack_fused_params(block, dtype)
    return block, (packed, f1, pyr, flow, h, inp, ctx, radius)


def _fused_work(args, dtype):
    """Operations and bytes of one fused step on these inputs, and the
    card's least time for them: the lookup (as K1 counts it) on fp32 FMA,
    the convs at the compute dtype's peak; each input and output once."""
    packed, f1, pyr, flow, h, inp, ctx, radius = args
    B, H, W, D = f1.shape
    P = B * H * W
    dh = h.shape[-1]
    din = packed["wzr"].shape[1]
    lk = packed["wc1"].shape[0]
    coords = flow + _x_grid(flow)
    look = _alt_bound(f1, pyr, coords, radius)
    conv_flops = 2 * P * (lk * 64 + 49 * 64 + 9 * 2 * 64 * 64 + 9 * 128 * 126
                          + 9 * din * 3 * dh + 9 * dh * 256 + 9 * 256)
    esize = 2 if dtype == "bfloat16" else 4
    weights = sum(v.numel() * v.element_size() for v in packed.values())
    n_bytes = (4 * (f1.numel() + sum(p.numel() for p in pyr) + flow.numel())
               + esize * (h.numel() + ctx.numel() + (inp.numel() if inp is not None else 0))
               + weights + esize * h.numel() + 4 * P)
    t_ops = 1e3 * (look["flops"] / FP32_FLOPS
                   + conv_flops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS))
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    return {"flops": look["flops"] + conv_flops, "conv_flops": conv_flops,
            "lookup_flops": look["flops"], "bytes": n_bytes,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _in_image_taps(H: int, W: int, k: int) -> int:
    """In-image taps of a k x k SAME window, summed over an H x W image."""
    r = k // 2

    def count(n):
        return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))

    return count(H) * count(W)


def _bound(n_bytes, flops):
    """The card's least time for moving ``n_bytes`` once and doing
    ``flops`` on fp32 FMA, and which of the two binds."""
    t_ops, t_bytes = 1e3 * flops / FP32_FLOPS, 1e3 * n_bytes / HBM_BYTES_PER_S
    return {"gflop": flops / 1e9, "bytes": n_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}


def _motion_in_bound(packed, f1, pyr, flow, radius, dtype):
    """Least time for K2's first launch (stage 1, motion_in_kernel) on these
    inputs: it reads f1, the pyramid and the flow (fp32) and convc1's and
    convf1's weights and writes cor|flo (128 channels in the compute
    dtype); it does the lookup's dot products and interpolation (as K1
    counts them, on this data), convc1's products and convf1's in-image
    7x7 taps, all on fp32 FMA."""
    B, H, W, D = f1.shape
    P = B * H * W
    es = 2 if dtype == "bfloat16" else 4
    look = _alt_bound(f1, pyr, flow + _x_grid(flow), radius)
    lk = packed["wc1"].shape[0]
    weights = es * (packed["wc1"].numel() + packed["kf7"].numel()) + 4 * 128
    return _bound(4 * (f1.numel() + sum(p.numel() for p in pyr) + flow.numel()) + weights
                  + es * P * 128,
                  look["flops"] + 2 * P * lk * 64 + 2 * 64 * B * _in_image_taps(H, W, 7))


def _head_out_bound(B, H, W, dtype):
    """Least time for K2's last launch (stage 7, head_out_kernel) over B
    images of H x W: it reads fh1 (256 channels) and the flow head conv2's
    x weights [9, 256] in the compute dtype and its bias, and writes delta
    (fp32); it does the 3x3x256 reduction's in-image taps on fp32 FMA."""
    es = 2 if dtype == "bfloat16" else 4
    return _bound(es * B * H * W * 256 + es * 9 * 256 + 4 + 4 * B * H * W,
                  2 * 256 * B * _in_image_taps(H, W, 3))


def _k2_stage_bounds(args, dtype):
    """Least time for K2's first and last launches on these inputs, from
    what each does in csrc/fused_update.cu: stage 1 as
    ``_motion_in_bound``, stage 7 as ``_head_out_bound``."""
    packed, f1, pyr, flow, h, inp, ctx, radius = args
    B, H, W, D = f1.shape
    return {
        "motion_in (lookup, convc1, convf1)": _motion_in_bound(packed, f1, pyr, flow, radius,
                                                               dtype),
        "head_out (flow head conv2)": _head_out_bound(B, H, W, dtype),
    }


def _x_grid(flow):
    import torch

    return torch.arange(flow.shape[-1], device=flow.device, dtype=torch.float32)


def _ulp_bf16(x: float) -> float:
    """Spacing of bfloat16 values at magnitude |x|."""
    return 2.0 ** (math.frexp(max(abs(x), 2.0 ** -126))[1] - 8)


def k2_errors(got, want, dtype) -> dict:
    """K2's (h', delta) against the plain step's on the same inputs, and
    whether they agree within K2_FP32_TOL or K2_BF16_TOL (by ``dtype``,
    the step's compute dtype)."""
    import torch

    (h_k, d_k), (h_p, d_p) = got, want
    diff_h = (h_k.float() - h_p.float()).abs()
    diff_d = (d_k - d_p).abs()
    err_h, err_d = float(diff_h.max()), float(diff_d.max())
    scale_d = float(d_p.abs().max())
    res = {"err_h": err_h, "err_delta": err_d, "mean_err_h": float(diff_h.mean()),
           "mean_err_delta": float(diff_d.mean()), "max_abs_delta": scale_d}
    if dtype == torch.float32:
        res.update(tol_h=K2_FP32_TOL["h"],
                   tol_delta=K2_FP32_TOL["delta_rel"] * max(1.0, scale_d))
        ok = True
    else:
        share = float((diff_h > 0).float().mean())
        res.update(tol_h=K2_BF16_TOL["h"],
                   tol_delta=K2_BF16_TOL["delta_ulps"] * _ulp_bf16(scale_d),
                   h_share=share, tol_h_share=K2_BF16_TOL["h_share"])
        ok = share <= K2_BF16_TOL["h_share"]
    res["ok"] = ok and err_h <= res["tol_h"] and err_d <= res["tol_delta"]  # False on NaN
    return res


def _ulps_bf16(x):
    """Elementwise spacing of bfloat16 values at |x| (values in [2^(e-1),
    2^e) are 2^(e-8) apart; none at an exact zero)."""
    import torch

    return torch.where(x == 0, 0.0, torch.exp2((torch.frexp(x).exponent - 8).float()))


def stage1_allowances(f1, pyr, flow, packed, radius, dtype):
    """For each cor|flo element of stage 1 on these inputs, in fp32: S, the
    sum of the magnitudes of its terms (|tap·w| over convc1's taps,
    |flow·w| over convf1's in-image taps, and |bias|), and the taps'
    rounding allowance (one bf16 ulp of each tap times |w|; zero for flo
    and in fp32)."""
    import torch
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    taps = corr_lookup_alt_plain(f1, pyr, flow + _x_grid(flow), radius).to(dtype).float()
    wc1 = packed["wc1"].float().abs()
    s_cor = taps.abs() @ wc1 + packed["bc1"].float().abs()
    fl = flow.to(dtype).float().abs()[:, None]
    kf7 = packed["kf7"].float().abs().t().reshape(64, 1, 7, 7)
    s_flo = F.conv2d(fl, kf7, padding=3).permute(0, 2, 3, 1) + packed["bf7"].float().abs()
    tap_cor = (_ulps_bf16(taps) @ wc1 if dtype == torch.bfloat16 else torch.zeros_like(s_cor))
    return torch.cat([s_cor, s_flo], -1), torch.cat([tap_cor, torch.zeros_like(s_flo)], -1)


def stage1_errors(got, want, allowances) -> dict:
    """Stage 1's cor|flo against the plain version's on the same inputs,
    and whether they agree within K2_STAGE1_FP32_TOL or K2_STAGE1_BF16_TOL
    (by the dtype); ``allowances`` is :func:`stage1_allowances` of those
    inputs."""
    import torch

    sums, tap_allow = allowances
    tiny = 1e-30  # keeps 0/0 at 0 where an allowance is 0
    diff = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    unit = 2.0 ** -24 * sums  # eps32·S
    res = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
           "max_abs_out": scale, "share": float((diff > 0).float().mean())}
    if want.dtype == torch.float32:
        res.update(tol=K2_STAGE1_FP32_TOL * max(1.0, scale),
                   order_ratio=float((diff / unit.clamp_min(tiny)).max()))
        res["ok"] = res["max_abs_err"] <= res["tol"]  # False on NaN
        return res
    ulp = _ulps_bf16(want.float())
    rounding = K2_STAGE1_BF16_TOL["ulps"] * ulp + tap_allow
    tol = rounding + K2_STAGE1_BF16_TOL["sum_eps"] * unit
    excess = (diff - rounding).clamp_min(0) / unit.clamp_min(tiny)
    res.update(max_ulps=float(torch.where(ulp > 0, diff / ulp.clamp_min(tiny), 0.0).max()),
               max_err_over_tol=float((diff / tol.clamp_min(tiny)).max()),
               order_ratio=float(excess.max()), tol_ulps=K2_STAGE1_BF16_TOL["ulps"],
               tol_sum_eps=K2_STAGE1_BF16_TOL["sum_eps"], tol_share=K2_STAGE1_BF16_TOL["share"])
    res["ok"] = res["max_err_over_tol"] <= 1.0 and res["share"] <= res["tol_share"]
    return res


def stage7_sums(fh1, packed, dtype):
    """S for each delta element of stage 7 on these inputs, in fp32: the
    sum of the magnitudes of its terms, |fh1·kfh2| over the in-image taps
    plus |bfh2|, by the plain route."""
    from raft_stereo_tpu_torch.ops import fused_update

    absolute = {"kfh2": packed["kfh2"].abs(), "bfh2": packed["bfh2"].abs()}
    return fused_update.reference_head_out(fh1.abs(), absolute, dtype)


def stage7_errors(got, want, sums) -> dict:
    """Stage 7's delta against the plain version's on the same inputs, and
    whether every element lies within K2_STAGE7_TOL["sum_eps"]·2^-24·S
    (``sums`` is :func:`stage7_sums` of those inputs)."""
    tiny = 1e-30  # keeps 0/0 at 0 where S is 0
    diff = (got.float() - want.float()).abs()
    unit = 2.0 ** -24 * sums
    ratio = float((diff / unit.clamp_min(tiny)).max())
    return {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "max_abs_out": float(want.abs().max()), "share": float((diff > 0).float().mean()),
            "order_ratio": ratio, "tol_sum_eps": K2_STAGE7_TOL["sum_eps"],
            "ok": ratio <= K2_STAGE7_TOL["sum_eps"]}  # False on NaN


# K2's five conv launches at the slice shape (dh 128, 128 inp16 channels):
# name, the bf16 kernel each runs as the profiler names it (N, epilogue),
# input and output channels, groups, and the bytes a pixel that the launch
# must read and write once (inputs, ctx, h, z; outputs).
K2_CONVS = (
    ("convc2|convf2", "conv_sm90<128, 0>", 128, 128, 2, 2 * 128, 2 * 128),
    ("motion", "conv_sm90<128, 1>", 128, 128, 1, 2 * 128 + 4, 2 * 128),
    ("z|r", "conv_sm90<256, 2>", 384, 256, 1, 2 * 384 + 2 * 256, 4 * 128 + 2 * 128),
    ("q", "conv_sm90<128, 3>", 384, 128, 1, 2 * 384 + 2 * 128 + 2 * 128 + 4 * 128, 2 * 128),
    ("flow_head_conv1", "conv_sm90<256, 0>", 128, 256, 1, 2 * 128, 2 * 256),
)


def _device_ms_by_kernel(run, reps):
    """torch.profiler over ``reps`` calls of ``run``: device ms a launch by
    kernel name, for the kernels launched in at least half of the calls
    (empty if the profiler saw no device time). One more call runs traced
    before them and is dropped (the schedule's warm-up step). A profile may
    miss some launches, so a kernel's time is its total over the launches
    the profiler saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        prof.step()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = getattr(e, "cuda_time_total", 0.0) if us is None else us
        if (us > 0 and e.count >= max(1, reps // 2) and "Memcpy" not in e.key
                and "Memset" not in e.key):
            out[e.key] = us / e.count / 1e3
    return out


def phase_k2_launches(reps: int = 20):
    """K2's 7 launches on the slice case (bf16, inp16), timed one by one:
    device ms each (torch.profiler, grouped by kernel name); for each
    launch its own bound (``_k2_stage_bounds`` for stages 1 and 7) and, for
    each conv launch, as a yardstick the port never calls, cuDNN's F.conv2d
    at the same channel counts (channels-last bf16, no epilogue).
    Run after the other kernels' timings, so that the profiler cannot slow
    them."""
    import torch
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.ops import fused_update

    dtype = torch.bfloat16
    _, args = _fused_inputs(1, 136, 240, 256, 4, 4, True, dtype, seed=SEED + 10)
    with _fp32_checks():
        times = _device_ms_by_kernel(
            lambda: fused_update.fused_refine_step(*args, compute_dtype=dtype), reps)
    B, H, W, _ = args[1].shape
    P = B * H * W
    launches = {}
    for key, ms in times.items():
        m = re.search(r"conv_sm90<[^0-9>]*(\d+)[^0-9>]+(\d+)>", key)
        name = next((c[0] for c in K2_CONVS if m and c[1] == f"conv_sm90<{m[1]}, {m[2]}>"), None)
        if name is None:
            name = ("motion_in (lookup, convc1, convf1)" if "motion_in_kernel" in key
                    else "head_out (flow head conv2)" if "head_out_kernel" in key else None)
        if name is not None:
            launches[name] = {"kernel": key, "ms": ms}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for name, _, cin, cout, groups, in_px, out_px in K2_CONVS:
        flops = 2 * P * 9 * cin * cout // groups
        n_bytes = P * (in_px + out_px) + 2 * 9 * cin * cout // groups
        t_ops, t_bytes = 1e3 * flops / BF16_FLOPS, 1e3 * n_bytes / HBM_BYTES_PER_S
        x = torch.randn((B, cin, H, W), generator=g, device="cuda").to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn((cout, cin // groups, 3, 3), generator=g, device="cuda")
        w = (0.05 * w).to(dtype).contiguous(memory_format=torch.channels_last)
        entry = launches.setdefault(name, {"kernel": None, "ms": None})
        entry.update(gflop=flops / 1e9, bytes=n_bytes, bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     library_ms=_time_ms(lambda: F.conv2d(x, w, padding=1, groups=groups), 50),
                     library_call="torch.nn.functional.conv2d (cuDNN), channels-last bf16, "
                                  "no epilogue")
        if entry["ms"]:
            entry["tflops"] = flops / entry["ms"] / 1e9
    for name, bound in _k2_stage_bounds(args, "bfloat16").items():
        launches.setdefault(name, {"kernel": None, "ms": None}).update(bound)
    # stage 7's yardstick: cuDNN's bare conv of fh1 with the x column of the
    # flow head's conv2 (256 -> 1, 3x3), channels-last bf16, no bias
    fh1 = torch.randn((B, fused_update.HEAD_CH, H, W), generator=g, device="cuda").to(dtype)
    fh1 = fh1.contiguous(memory_format=torch.channels_last)
    kfh2 = args[0]["kfh2"].to(dtype)  # [9, 256]
    w2 = kfh2.t().reshape(1, fused_update.HEAD_CH, 3, 3).contiguous(
        memory_format=torch.channels_last)
    launches["head_out (flow head conv2)"].update(
        library_ms=_time_ms(lambda: F.conv2d(fh1, w2, padding=1), 50),
        library_call="torch.nn.functional.conv2d (cuDNN) 256 -> 1, 3x3, channels-last bf16, "
                     "no bias")
    launches["motion_in (lookup, convc1, convf1)"]["geometry"] = _stage1_geometry(args[1],
                                                                                  args[2])
    res = {"profiler_saw_device_time": bool(times), "launches": launches}
    emit({"phase": "k2_launches", "case": "slice_544x960_bf16", **res})
    return res


def phase_fused_check():
    """K2 against ``reference_refine_step`` on the card. The slice shape is
    the main path's (544x960 padded input at 1/4 resolution); bf16 is the
    preset's compute dtype, fp32 the parity phase's. The engine_* cases are
    the fused engine's, batch 4 in each of its two buckets."""
    import torch

    from raft_stereo_tpu_torch.ops import fused_update

    cases = [
        # name, (B, H, W, D), levels, radius, inp16, dtype, reps
        ("slice_544x960_bf16", (1, 136, 240, 256), 4, 4, True, "bfloat16", 50),
        ("slice_544x960_fp32", (1, 136, 240, 256), 4, 4, True, "float32", 20),
        ("ragged_b2_h37_w123_fp32", (2, 37, 123, 256), 4, 4, True, "float32", 20),
        ("ragged_b2_h37_w123_bf16", (2, 37, 123, 256), 4, 4, True, "bfloat16", 20),
        ("no_inp16_din256_fp32", (1, 136, 240, 256), 4, 4, False, "float32", 20),
        ("no_inp16_din256_bf16", (1, 136, 240, 256), 4, 4, False, "bfloat16", 20),
        ("engine_b4_544x960_bf16", (4, 136, 240, 256), 4, 4, True, "bfloat16", 20),
        ("engine_b4_480x640_bf16", (4, 120, 160, 256), 4, 4, True, "bfloat16", 20),
    ]
    checks, fault_inputs = [], {}
    with _fp32_checks(), tempfile.TemporaryDirectory(prefix="chip_smoke_k2_") as tmp:
        for name, (B, H, W, D), levels, radius, with_inp, dname, reps in cases:
            dtype = getattr(torch, dname)
            block, args = _fused_inputs(B, H, W, D, levels, radius, with_inp, dtype,
                                        seed=SEED + 10 + len(checks))
            got = fused_update.fused_refine_step(*args, compute_dtype=dtype)
            torch.cuda.synchronize()
            want = fused_update.reference_refine_step(*args, compute_dtype=dtype)
            res = {"case": name, "shape": [B, H, W, D], "levels": levels, "radius": radius,
                   "inp16": with_inp, "dtype": dname, **k2_errors(got, want, dtype)}
            if name in K2_FAULT_CASES:  # the cases that must catch planted faults
                fault_inputs[name] = (args, want)
            res["ms"] = _time_ms(lambda: fused_update.fused_refine_step(
                *args, compute_dtype=dtype), reps)
            res["plain_ms"] = _time_ms(lambda: fused_update.reference_refine_step(
                *args, compute_dtype=dtype), 3, warmup=1)
            res["unfused_port_step_ms"] = _time_ms(_unfused_step(block, args, dtype), reps)
            res.update(_fused_work(args, dname))
            emit({"phase": "kernel_check", "kernel": "fused_update", **res})
            checks.append(res)
            del block, args, got, want
            torch.cuda.empty_cache()
        faults = _k2_planted_faults(fault_inputs, torch.bfloat16, Path(tmp))
    emit({"phase": "k2_planted_faults", "cases": K2_FAULT_CASES, "faults": faults})
    bad = [c["case"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"fused_update disagrees with its plain step in {bad}")
    slice_case, ragged_case = K2_FAULT_CASES
    case_of = {f["fault"]: ragged_case if f["fault"] in K2_RAGGED_FAULTS else slice_case
               for f in faults}
    missed = [f"{f['fault']} ({case_of[f['fault']]})" for f in faults
              if f[case_of[f["fault"]]]["ok"]]
    missed += [f"{f['fault']} (stage 1)" for f in faults
               if f["fault"] in K2_STAGE1_FAULTS and f[slice_case]["stage1"]["ok"]]
    missed += [f"{f['fault']} (stage 7, {case_of[f['fault']]})" for f in faults
               if f["fault"] in K2_STAGE7_FAULTS and f[case_of[f["fault"]]]["stage7"]["ok"]]
    if len(faults) != len(K2_MUTANTS) or missed:
        raise AssertionError(f"the bf16 K2 check passes the planted faults {missed}")
    return checks


def _stage1_geometry(f1, pyr) -> dict:
    """Stage 1's launch geometry at these shapes, with its waves on this
    card (blocks over the SMs times the blocks an SM holds)."""
    import torch

    from raft_stereo_tpu_torch.ops import fused_update

    B, H, W, D = f1.shape
    geo = fused_update.motion_in_geometry(B * H, W, [p.shape[2] for p in pyr], D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {**geo._asdict(), "waves": geo.blocks / (sms * geo.per_sm)}


# name, (B, H, W, D), reps: the slice shape (the main path's), rows of two
# ragged segments, the fused engine's batch-4 buckets and the Middlebury-F
# width; each in bf16 and fp32
K2_STAGE1_CASES = (
    ("slice_544x960", (1, 136, 240, 256), 50),
    ("ragged_b2_h37_w123", (2, 37, 123, 256), 50),
    ("engine_b4_544x960", (4, 136, 240, 256), 20),
    ("engine_b4_480x640", (4, 120, 160, 256), 20),
    ("middlebury_F_1984x2880", (1, 496, 720, 256), 10),
)


def phase_k2_stage1_check():
    """K2's first launch alone (``fused_update.motion_in``) against
    ``reference_motion_in`` on the card, 4 levels at radius 4, in bf16 and
    fp32 (TF32 off): each case's errors (``stage1_errors``), its device time
    under torch.profiler, its plain version's time, its bound
    (``_motion_in_bound``) and its geometry."""
    import torch

    from raft_stereo_tpu_torch.ops import fused_update

    checks = []
    with _fp32_checks():
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            for name, (B, H, W, D), reps in K2_STAGE1_CASES:
                _, args = _fused_inputs(B, H, W, D, 4, 4, False, dtype,
                                        seed=SEED + 30 + len(checks))
                packed, f1, pyr, flow, radius = args[0], args[1], args[2], args[3], args[7]
                before = fused_update.MOTION_IN_LAUNCHES
                got = fused_update.motion_in(f1, pyr, flow, packed, radius, dtype)
                torch.cuda.synchronize()
                launched = fused_update.MOTION_IN_LAUNCHES - before
                want = fused_update.reference_motion_in(f1, pyr, flow, packed, radius, dtype)
                res = {"case": name, "shape": [B, H, W, D], "dtype": dname,
                       "launched": launched,
                       **stage1_errors(got, want,
                                       stage1_allowances(f1, pyr, flow, packed, radius, dtype))}
                times = _device_ms_by_kernel(
                    lambda: fused_update.motion_in(f1, pyr, flow, packed, radius, dtype), reps)
                res["ms"] = next((v for k, v in times.items() if "motion_in_kernel" in k), None)
                res["plain_ms"] = _time_ms(lambda: fused_update.reference_motion_in(
                    f1, pyr, flow, packed, radius, dtype), 3, warmup=1)
                res.update(_motion_in_bound(packed, f1, pyr, flow, radius, dname))
                res["geometry"] = _stage1_geometry(f1, pyr)
                emit({"phase": "k2_stage1_check", **res})
                checks.append(res)
                del args, packed, f1, pyr, flow, got, want
                torch.cuda.empty_cache()
    bad = [f"{c['case']} {c['dtype']}" for c in checks if not c["ok"] or c["launched"] != 1]
    if bad:
        raise AssertionError(f"fused_update stage 1 disagrees with its plain version in {bad}")
    return checks


# name, (B, H, W), reps: stage 1's cases at stage 7's input, and a tile
# larger than the image (three images of 5 x 17 in one 8 x 32 tile each)
K2_STAGE7_CASES = (
    *(((name, shape[:3], reps) for name, shape, reps in K2_STAGE1_CASES)),
    ("tile_over_image_b3_h5_w17", (3, 5, 17), 50),
)


def stage7_fh1(B, H, W, dtype, seed):
    """Stage 7's input at the scale the model gives it: the relu of seeded
    unit normals, [B, H, W, 256] in ``dtype``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.relu(torch.randn((B, H, W, 256), generator=g, device="cuda")).to(dtype)


def phase_k2_stage7_check():
    """K2's last launch alone (``fused_update.head_out``) against
    ``reference_head_out`` on the card, in bf16 and fp32 (TF32 off): each
    case's launches, its errors (``stage7_errors``), whether two calls agree
    bitwise, its device time under torch.profiler, its plain version's time,
    its bound (``_head_out_bound``), cuDNN's bare 256 -> 1 conv on the same
    input (channels-last, no bias; a yardstick the port never calls) and the
    launch geometry. fh1 is ``stage7_fh1``; kfh2 and bfh2 are
    ``_fused_inputs``' packed weights."""
    import torch
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.ops import fused_update

    checks = []
    with _fp32_checks():
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            for name, (B, H, W), reps in K2_STAGE7_CASES:
                seed = SEED + 50 + len(checks)
                packed = _fused_inputs(1, 8, 8, 256, 4, 4, True, dtype, seed=seed)[1][0]
                fh1 = stage7_fh1(B, H, W, dtype, seed)
                before = fused_update.HEAD_OUT_LAUNCHES
                got = fused_update.head_out(fh1, packed, dtype)
                again = fused_update.head_out(fh1, packed, dtype)
                torch.cuda.synchronize()
                launched = fused_update.HEAD_OUT_LAUNCHES - before
                want = fused_update.reference_head_out(fh1, packed, dtype)
                res = {"case": name, "shape": [B, H, W, fused_update.HEAD_CH], "dtype": dname,
                       "launched": launched, "bitwise_repeatable": bool(torch.equal(got, again)),
                       **stage7_errors(got, want, stage7_sums(fh1, packed, dtype))}
                for _ in range(3):  # a profile may miss a short kernel's launches
                    times = _device_ms_by_kernel(
                        lambda: fused_update.head_out(fh1, packed, dtype), reps)
                    res["ms"] = next((v for k, v in times.items() if "head_out_kernel" in k),
                                     None)
                    if res["ms"] is not None:
                        break
                res["plain_ms"] = _time_ms(lambda: fused_update.reference_head_out(
                    fh1, packed, dtype), 5, warmup=1)
                res.update(_head_out_bound(B, H, W, dname))
                x = fh1.permute(0, 3, 1, 2)  # NCHW view of channels-last storage
                w2 = packed["kfh2"].t().reshape(1, fused_update.HEAD_CH, 3, 3).contiguous(
                    memory_format=torch.channels_last)
                res["library_ms"] = _time_ms(lambda: F.conv2d(x, w2, padding=1), reps)
                res["library_call"] = (f"torch.nn.functional.conv2d (cuDNN) 256 -> 1, 3x3, "
                                       f"channels-last {dname}, no bias")
                res["geometry"] = {**fused_update.head_out_geometry(B, H, W)._asdict(),
                                   "sms": torch.cuda.get_device_properties(0).multi_processor_count}
                emit({"phase": "k2_stage7_check", **res})
                checks.append(res)
                del packed, fh1, got, again, want, x
                torch.cuda.empty_cache()
    bad = [f"{c['case']} {c['dtype']}" for c in checks
           if not c["ok"] or c["launched"] != 2 or not c["bitwise_repeatable"]]
    if bad:
        raise AssertionError(f"fused_update stage 7 disagrees with its plain version in {bad}")
    return checks


def _k2_planted_faults(cases, dtype, tmp: Path):
    """Each fault of K2_MUTANTS, run on the inputs of each of ``cases``
    (name -> (step arguments, the plain step's result)): the step held to
    the plain step, its stage 1 to the plain stage 1 and its stage 7, on
    ``stage7_fh1`` at the case's shape, to the plain stage 7, case by
    case."""
    from raft_stereo_tpu_torch.ops import fused_update

    def stage1_args(args):  # fmap1, the pyramid, the flow, the weights, the radius
        return args[1], args[2], args[3], args[0], args[7]

    fh1 = {name: stage7_fh1(*args[1].shape[:3], dtype, SEED + 70 + i)
           for i, (name, (args, _)) in enumerate(cases.items())}
    plain = {name: (fused_update.reference_motion_in(*stage1_args(args), dtype),
                    stage1_allowances(*stage1_args(args), dtype),
                    fused_update.reference_head_out(fh1[name], args[0], dtype),
                    stage7_sums(fh1[name], args[0], dtype))
             for name, (args, _) in cases.items()}

    def run():
        return {name: (fused_update.fused_refine_step(*args, compute_dtype=dtype),
                       fused_update.motion_in(*stage1_args(args), dtype),
                       fused_update.head_out(fh1[name], args[0], dtype))
                for name, (args, _) in cases.items()}

    def errors(out):
        return {name: {**k2_errors(step, cases[name][1], dtype),
                       "stage1": stage1_errors(cf, *plain[name][:2]),
                       "stage7": stage7_errors(delta, *plain[name][2:])}
                for name, (step, cf, delta) in out.items()}

    return _planted_faults(fused_update, K2_MUTANTS, run, errors, tmp)


def _planted_faults(module, mutants, run, errors, tmp: Path):
    """Each (name, text, replacement) of ``mutants`` planted in a copy of
    ``module``'s kernel source (built into ``tmp``, one ``nvcc`` each, all
    started together); ``run()`` calls the wrapper with the mutant bound
    and ``errors(got)`` holds its result."""
    import ctypes

    from raft_stereo_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / f"{module.KERNEL}.cu").read_text()
    procs = []
    try:
        for name, old, new in mutants:
            if src.count(old) != 1:
                raise AssertionError(f"planted fault {name}: its text is not in the source once")
            cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
            cu.write_text(src.replace(old, new))
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                   "-o", str(so), str(cu)]
            procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
        saved = (_build._libs.pop(module.KERNEL, None), module._fn)
        faults = []
        try:
            for name, so, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for planted fault {name}:\n{log}")
                # the wrapper binds whatever library _build has loaded
                _build._libs[module.KERNEL] = ctypes.CDLL(str(so))
                module._fn = None
                faults.append({"fault": name, **errors(run())})
        finally:
            _build._libs.pop(module.KERNEL, None)
            if saved[0] is not None:
                _build._libs[module.KERNEL] = saved[0]
            module._fn = saved[1]
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return faults


def k3_inputs(B, H, W, dtype, prologue=None, seed=0):
    """Seeded K3 arguments ``(xp, weight, scale, shift, relu_prologue)``:
    unit-variance activations in ``dtype`` as the packed view of
    channels-last storage, the conv weight at the port's init scale
    (kaiming, fan_out 576) packed HWIO in ``dtype``, and for ``prologue`` "relu" (scale in
    [0.5, 1.5) drawn per lane, so the two column parities differ, and a
    positive shift, then relu) or "affine" (the same scale, a shift of
    both signs, no relu)."""
    import torch

    from raft_stereo_tpu_torch.experiments.packed_conv import pack_weight, pack_x

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, H, W, 64), generator=g, device="cuda").to(dtype)
    weight = torch.randn((64, 64, 3, 3), generator=g, device="cuda") * math.sqrt(2.0 / 576)
    weight = pack_weight(weight, dtype)
    scale = shift = None
    if prologue is not None:
        scale = 0.5 + torch.rand((B, 128), generator=g, device="cuda")
        shift = torch.rand((B, 128), generator=g, device="cuda")
        shift = 0.1 + 0.5 * shift if prologue == "relu" else shift - 0.5
    return pack_x(x), weight, scale, shift, prologue == "relu"


def _k3_work(xp, scale):
    """Operations and bytes of one K3 call on these inputs, and the
    card's least time for them: the products of the taps that fall inside
    the image ((3H-2)(3W-2) (pixel, tap) pairs an image, 64x64 MACs each)
    at the dtype's peak; the input, the weight, scale and shift read once
    and the output written once."""
    import torch

    B, H, W2, _ = xp.shape
    W = 2 * W2
    esize = xp.element_size()
    flops = 2 * 64 * 64 * B * (3 * H - 2) * (3 * W - 2)
    n_bytes = esize * (2 * xp.numel() + 9 * 64 * 64 + (0 if scale is None else 2 * B * 128))
    t_ops = 1e3 * flops / (BF16_FLOPS if xp.dtype == torch.bfloat16 else FP32_FLOPS)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": n_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k3_abs_sums(xp, weight, scale=None, shift=None, relu_prologue=False):
    """S = sum |x·w| over each output's 576 products, in fp32: the plain
    conv of |prologue(x)| (the dtype's values) with |weight|."""
    from raft_stereo_tpu_torch.experiments import packed_conv

    x = xp if scale is None else packed_conv.prologue(xp, scale, shift, relu_prologue)
    return packed_conv.packed_conv3x3_plain(x.abs().float(), weight.abs().float())


def k3_errors(got, want, sums) -> dict:
    """K3's output against the plain version's on the same inputs, and
    whether they agree within K3_FP32_TOL or K3_BF16_TOL (by the dtype);
    ``sums`` is :func:`k3_abs_sums` of those inputs."""
    import torch

    tiny = 1e-30  # keeps 0/0 at 0 where an allowance is 0
    diff = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    unit = 2.0 ** -24 * sums  # eps32·S
    res = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
           "max_abs_out": scale, "max_abs_sum": float(sums.max())}
    if want.dtype == torch.float32:
        res.update(tol=K3_FP32_TOL * max(1.0, scale),
                   order_ratio=float((diff / unit.clamp_min(tiny)).max()))
        res["ok"] = res["max_abs_err"] <= res["tol"]  # False on NaN
        return res
    # one bf16 ulp at each plain value's magnitude (values in
    # [2^(e-1), 2^e) are 2^(e-8) apart; none at an exact zero), plus the
    # element's own order allowance
    ulp = _ulps_bf16(want.float())
    rounding = K3_BF16_TOL["ulps"] * ulp
    tol = rounding + K3_BF16_TOL["sum_eps"] * unit
    excess = (diff - rounding).clamp_min(0) / unit.clamp_min(tiny)
    res.update(max_ulps=float(torch.where(ulp > 0, diff / ulp.clamp_min(tiny), 0.0).max()),
               max_err_over_tol=float((diff / tol.clamp_min(tiny)).max()),
               order_ratio=float(excess.max()), share=float((diff > 0).float().mean()),
               tol_ulps=K3_BF16_TOL["ulps"], tol_sum_eps=K3_BF16_TOL["sum_eps"],
               tol_share=K3_BF16_TOL["share"])
    res["ok"] = res["max_err_over_tol"] <= 1.0 and res["share"] <= res["tol_share"]
    return res


# name, (B, H, W), prologue, reps
K3_CASES = (
    ("encoder_2x272x480", (2, 272, 480), None, 100),
    ("encoder_prologue_relu", (2, 272, 480), "relu", 50),
    ("encoder_prologue_affine", (2, 272, 480), "affine", 50),
    ("ragged_b1_37x122", (1, 37, 122), "relu", 50),
    # the realtime engine's: batch 4, the stacked pair, in each bucket
    ("engine_8x272x480", (8, 272, 480), None, 20),
    ("engine_8x240x320", (8, 240, 320), None, 20),
)


def phase_packed_conv_check():
    """K3 against its plain version on the card, each case in bf16 (the
    preset's dtype) and fp32 (TF32 off); the first case is the realtime
    main path's shape (the stacked 544x960 pair after the stride-2 stem).
    Beside each: cuDNN's conv (``F.conv2d`` on the same channels-last
    input, no prologue), the library call that computes K3's no-prologue
    form. The bf16 check must fail every fault of K3_MUTANTS on the
    prologue case."""
    import torch
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.experiments import packed_conv

    checks, faults = [], []
    with _fp32_checks(), tempfile.TemporaryDirectory(prefix="chip_smoke_k3_") as tmp:
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            for name, (B, H, W), prologue, reps in K3_CASES:
                args = k3_inputs(B, H, W, dtype, prologue, seed=SEED + 20 + len(checks))
                got = packed_conv.packed_conv3x3(*args)
                torch.cuda.synchronize()
                want = packed_conv.packed_conv3x3_plain(*args)
                sums = k3_abs_sums(*args)
                res = {"case": name, "shape": [B, H, W, 64], "dtype": dname,
                       "prologue": prologue, **k3_errors(got, want, sums)}
                if dtype == torch.bfloat16 and prologue == "relu" and not faults:
                    faults = _planted_faults(packed_conv, K3_MUTANTS,
                                             lambda: packed_conv.packed_conv3x3(*args),
                                             lambda out: k3_errors(out, want, sums), Path(tmp))
                res["ms"] = _time_ms(lambda: packed_conv.packed_conv3x3(*args), reps)
                res["plain_ms"] = _time_ms(lambda: packed_conv.packed_conv3x3_plain(*args), 5,
                                           warmup=1)
                x = packed_conv.unpack_x(args[0]).permute(0, 3, 1, 2)  # channels-last NCHW
                # the same weight as OIHW, laid out as cuDNN takes it (outside the timing,
                # as K3's is)
                w = args[1].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                res["library_ms"] = _time_ms(lambda: F.conv2d(x, w, padding=1), reps)
                res["library_call"] = "torch.nn.functional.conv2d (cuDNN), no prologue"
                res.update(_k3_work(args[0], args[2]))
                emit({"phase": "kernel_check", "kernel": "packed_conv", **res})
                checks.append(res)
                del args, got, want, sums, x, w
                torch.cuda.empty_cache()
    emit({"phase": "k3_planted_faults", "case": "encoder_prologue_relu bfloat16", "faults": faults})
    bad = [f"{c['case']} {c['dtype']}" for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"packed_conv disagrees with its plain version in {bad}")
    missed = [f["fault"] for f in faults if f["ok"]]
    if len(faults) != len(K3_MUTANTS) or missed:
        raise AssertionError(f"the bf16 K3 check passes the planted faults {missed}")
    return checks


def _unfused_step(block, args, dtype):
    """The port's unfused step at the same shape, for comparison (it is not
    a library call): K1's lookup, then the update block's cuDNN convs."""
    import torch

    from raft_stereo_tpu_torch.ops import alt_corr

    packed, f1, pyr, flow, h, inp, ctx, radius = args
    coords = flow + _x_grid(flow)
    h_n = h.permute(0, 3, 1, 2).contiguous()
    inp_n = None if inp is None else inp.permute(0, 3, 1, 2).contiguous()
    cz, cr, cq = ctx.permute(0, 3, 1, 2).contiguous().chunk(3, dim=1)

    @torch.no_grad()
    def run():
        corr = alt_corr.corr_lookup_alt(f1, pyr, coords, radius).to(dtype).permute(0, 3, 1, 2)
        motion = block.encoder(flow[:, None].to(dtype), corr)
        xs = (motion,) if inp_n is None else (motion, inp_n)
        h_new = block.gru08(h_n, cz, cr, cq, *xs)
        return h_new, block.flow_head(h_new)

    return run


def _write_pairs(root: Path, n: int, H: int = 540, W: int = 960, seed: int = SEED,
                 first: int = 0):
    """``n`` seeded synthetic stereo pairs: a smoothed random texture and a
    copy shifted by a per-pair disparity, as PNGs in ``root/pairK/im{0,1}``
    for K from ``first``; returns each pair's disparity."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    pad = 64
    disps = []
    for k in range(first, first + n):
        tex = rng.rand(H, W + 2 * pad, 3)
        for axis in (0, 1):  # 5-tap box blur along each axis
            tex = sum(np.roll(tex, s, axis=axis) for s in range(-2, 3)) / 5.0
        tex = (tex * 255).astype(np.uint8)
        d = 8 + 12 * (k % 4)  # within the 64-pixel margin
        left = tex[:, pad : pad + W]
        right = tex[:, pad + d : pad + d + W]  # right(x) = left(x + d)
        pair = root / f"pair{k}"
        pair.mkdir(parents=True)
        Image.fromarray(np.ascontiguousarray(left)).save(pair / "im0.png")
        Image.fromarray(np.ascontiguousarray(right)).save(pair / "im1.png")
        disps.append(d)
    return disps


def phase_main_path(tmp: Path, fused: bool = False, n_pairs: int = 4, iters: int = 32,
                    preset: str = "raftstereo-middlebury", packed: bool = False):
    """The port's demo entry point on its per-image path (``--per_image``,
    the forward captured once per shape) with ``preset``; with ``fused``
    also ``--fused_update``, with ``packed`` the packed encoder stage
    (``models.extractor._ENABLE_PACKED``, put back afterwards). Every kernel
    count is set to 0 just before the run and read just after: the wrapper
    counters count the warm-up's and the capture's launches, and the path's
    launches are each kernel's launches at capture times the replays."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import demo
    from raft_stereo_tpu_torch.models import extractor

    name = "main_path" + ("_realtime" if preset == "raftstereo-realtime" else "")
    name += ("_fused" if fused else "") + ("_packed" if packed else "")
    data, out = tmp / "pairs", tmp / f"out_{name}"
    if not data.exists():
        _write_pairs(data, n_pairs)
    argv = ["--preset", preset, "--valid_iters", str(iters), "--per_image",
            "--left_imgs", str(data / "*" / "im0.png"),
            "--right_imgs", str(data / "*" / "im1.png"),
            "--output_directory", str(out), "--save_numpy"]
    if fused:
        argv.append("--fused_update")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = packed
    try:
        _zero_launches()
        t0 = time.perf_counter()
        run = demo.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wrapper = _launches()
    finally:
        extractor._ENABLE_PACKED = saved
    peak = torch.cuda.max_memory_allocated()
    graphs = run.graphs
    launches = dict(graphs.replayed_launches)
    seconds = run.seconds

    if run.saved != n_pairs or len(seconds) != n_pairs:
        raise AssertionError(f"demo served {run.saved} pairs, expected {n_pairs}")
    if (graphs.captures, graphs.replays) != (1, n_pairs):
        raise AssertionError(f"{graphs.captures} captures and {graphs.replays} replays, "
                             f"expected 1 and {n_pairs}")
    want = ({"alt_corr": n_pairs, "fused_update": n_pairs * (iters - 1)} if fused
            else {"alt_corr": n_pairs * iters, "fused_update": 0})
    # the realtime preset's shared backbone: one packed trunk a stacked pair
    want["packed_conv"] = n_pairs * K3_PER_TRUNK if packed else 0
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if wrapper != {k: 2 * n // n_pairs for k, n in want.items()}:  # warm-up + capture
        raise AssertionError(f"wrapper counts {wrapper}, expected the warm-up's and the "
                             f"capture's launches of {want} / {n_pairs} pairs")
    for k in range(n_pairs):
        disp = np.load(out / f"pair{k}.npy")
        if disp.shape != (540, 960) or not np.isfinite(disp).all():
            raise AssertionError(f"pair{k}: disparity {disp.shape}, finite={np.isfinite(disp).all()}")
        if not (out / f"pair{k}.png").is_file():
            raise AssertionError(f"pair{k}.png missing")
    steady = seconds[1:] or seconds
    res = {
        "phase": name,
        "entry": "raft_stereo_tpu_torch.demo.main --per_image", "preset": preset,
        "fused_update": fused, "packed_stage": packed, "pairs": n_pairs, "input": [540, 960],
        "padded": [544, 960], "iters": iters, "launches": launches,
        "launches_counted_as": "launches at capture x replays",
        "wrapper_launches_warmup_and_capture": wrapper,
        "captures": graphs.captures, "capture_s": graphs.capture_s, "replays": graphs.replays,
        "first_pair_ms_with_capture": seconds[0] * 1e3,
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


def _launches():
    from raft_stereo_tpu_torch.runtime.infer import kernel_launches

    return kernel_launches()


def _zero_launches():
    from raft_stereo_tpu_torch.experiments import packed_conv
    from raft_stereo_tpu_torch.ops import alt_corr, fused_update

    alt_corr.LAUNCHES = fused_update.LAUNCHES = packed_conv.LAUNCHES = 0


@contextlib.contextmanager
def _launches_kept():
    """Launches made to compare or time a forward outside a path's run do
    not count: the counters are put back afterwards."""
    from raft_stereo_tpu_torch.experiments import packed_conv
    from raft_stereo_tpu_torch.ops import alt_corr, fused_update

    saved = (alt_corr.LAUNCHES, fused_update.LAUNCHES, packed_conv.LAUNCHES)
    try:
        yield
    finally:
        alt_corr.LAUNCHES, fused_update.LAUNCHES, packed_conv.LAUNCHES = saved


def phase_captured_forward(tmp: Path, reps: int = 5):
    """``make_forward`` at batch 1 on the padded 544x960 pair, for the
    slice-1 (raftstereo-middlebury, 32 iterations) and the realtime
    (7 iterations) cells: the eager forward and the captured one timed in
    turns in the same run (eager, captured, captured, eager; host clock
    over ``reps`` forwards ending in a synchronize), and the replay held to
    the eager forward bitwise."""
    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model, make_forward

    a, b = _first_pair(tmp)
    cells = []
    for preset, iters in (("raftstereo-middlebury", 32), ("raftstereo-realtime", 7)):
        model = load_model(PRESETS[preset], seed=SEED)
        forward = make_forward(model, iters)
        with _launches_kept():
            def eager():
                return model(a, b, iters=iters)[1]

            def captured():
                return forward(a, b)

            want, got = eager(), captured()
            torch.cuda.synchronize()
            ms = {"eager": [], "captured": []}
            for kind in ("eager", "captured", "captured", "eager"):
                fn = eager if kind == "eager" else captured
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                ms[kind].append(1e3 * (time.perf_counter() - t0) / reps)
        cell = {"preset": preset, "iters": iters, "batch": 1, "padded": list(a.shape[1:3]),
                "eager_ms": ms["eager"], "captured_ms": ms["captured"],
                "speedup": sum(ms["eager"]) / sum(ms["captured"]),
                "capture_s": forward.graphs.capture_s,
                "bitwise_equal": bool(torch.equal(got, want)),
                "max_abs_diff": float((got - want).abs().max())}
        cells.append(cell)
        del model, forward, want, got
        torch.cuda.empty_cache()
    emit({"phase": "captured_forward", "cells": cells, "card": smi_line()})
    bad = [c["preset"] for c in cells if not c["bitwise_equal"]]
    if bad:
        raise AssertionError(f"captured forward differs from the eager one: {bad}")
    return cells


# Engine cells: 6 pairs at 540x960 and 3 at 480x640 (buckets 544x960 and
# 480x640), batch 4: batches of 4 + 2 and of 3, two with filler.
ENGINE_PAIRS = ((6, 540, 960), (3, 480, 640))
ENGINE_BATCH = 4
# Batched against per-image disparities: the first batch's forward at batch
# 4 against each of its pairs alone at batch 1, both eager. The two are not
# bitwise equal: cuDNN picks other bf16 conv algorithms for another batch
# size, which sum in another order (the phase's witness: the same
# comparison with cuDNN off, reported beside it), and with seeded random
# weights the refinement loop amplifies such a difference step by step (by
# the preset's last step the median pixel differs by tens of px). So the
# held comparison is one refinement iteration's forward, before the
# amplification; the full depth's difference is reported beside it.
# Measured on an H100 at one iteration: median 0.046 px (middlebury, fused)
# and 0.102 px (realtime packed), max 0.86 and 0.77 px, no pixel off by
# 1 px. A first limit of median 0.05 px failed on the realtime cell at
# 0.102; the limit is about three times the worst median and 2.3 times the
# worst max, and each run reads two planted routing faults against it
# (a rolled batch, an unpad window two rows off), which it must fail.
ENGINE_PER_IMAGE_TOL = {"median_px": 0.3, "max_px": 2.0}


def _diff_stats(diffs):
    import numpy as np

    d = np.concatenate([x.ravel() for x in diffs])
    return {"max_px": float(d.max()), "mean_px": float(d.mean()),
            "median_px": float(np.median(d)), "share_over_1px": float((d > 1).mean()),
            "share_bitwise_equal": float((d == 0).mean()),
            "pairs_bitwise_equal": sum(int(x.max() == 0) for x in diffs)}


def _engine_pairs_per_s(engine, requests, reps: int = 2):
    """Pairs/s of ``engine.stream`` over in-memory requests (no decode, no
    files), after one stream that captures or warms up."""
    import torch

    list(engine.stream(iter(requests)))
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(r.ok for r in engine.stream(iter(requests)))
        out.append(n / (time.perf_counter() - t0))
    return out


def phase_engine_path(tmp: Path, preset: str = "raftstereo-middlebury", iters: int = 32,
                      fused: bool = False, packed: bool = False):
    """``demo.main`` on its default path, the batched engine (batch 4), over
    ENGINE_PAIRS: two buckets, each with a partial batch. Every kernel count
    is set to 0 just before the run and read just after. Checks: every
    result came back; two captures and three replays; each kernel's
    launches (at capture x replays) as the path needs them; the served
    outputs of the first batch equal an eager run of the same batch
    bitwise; batched against per-image disparities within
    ENGINE_PER_IMAGE_TOL, which must not pass two planted routing faults
    (a rolled batch, an unpad window two rows off); the same comparison
    with cuDNN off, reported as the witness for the gap's cause. Then the engine's own pairs/s over the same pairs
    in memory, captured against eager (an engine with ``capture=False``) in
    turns in the same run."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import demo
    from raft_stereo_tpu_torch.demo import load_image
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.ops.pad import BatchPadder, InputPadder
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferRequest

    name = "engine_path" + ("_realtime" if preset == "raftstereo-realtime" else "")
    name += ("_fused" if fused else "") + ("_packed" if packed else "")
    data, out = tmp / "engine_pairs", tmp / f"out_{name}"
    if not data.exists():
        first = 0
        for n, H, W in ENGINE_PAIRS:
            _write_pairs(data, n, H, W, seed=SEED + first, first=first)
            first += n
    shapes = [(H, W) for n, H, W in ENGINE_PAIRS for _ in range(n)]
    n_pairs = len(shapes)
    argv = ["--preset", preset, "--valid_iters", str(iters), "--infer_batch", str(ENGINE_BATCH),
            "--left_imgs", str(data / "*" / "im0.png"),
            "--right_imgs", str(data / "*" / "im1.png"),
            "--output_directory", str(out), "--save_numpy"]
    if fused:
        argv.append("--fused_update")
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = packed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        run = demo.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wrapper = _launches()
        peak = torch.cuda.max_memory_allocated()
        model, engine, graphs = run.model, run.engine, run.graphs
        stats = engine.stats
        launches = dict(graphs.replayed_launches)
        per_graph = {f"{k[0][0]}x{k[0][1]}": e.launches for k, e in graphs.items()}
        demo_stats = {"captures": graphs.captures, "capture_s": graphs.capture_s,
                      "replays": graphs.replays, "batch_device_ms": list(stats.batch_ms),
                      "ms_per_pair_replayed": sum(stats.batch_ms) / sum(stats.batch_valid),
                      "stream_s": stats.stream_s,
                      "pairs_per_s": n_pairs / (stats.stream_s - graphs.capture_s),
                      "breakdown_ms": stats.breakdown_ms(), "underruns": stats.underruns}

        buckets = {(544, 960): 6, (480, 640): 3}
        if (run.saved, stats.images, stats.failed) != (n_pairs, n_pairs, 0):
            raise AssertionError(f"{run.saved} saved, {stats.images} served, {stats.failed} "
                                 f"failed; expected {n_pairs} served")
        if stats.buckets != buckets or stats.padded_slots != 3:
            raise AssertionError(f"buckets {stats.buckets}, padded {stats.padded_slots}")
        if (graphs.captures, graphs.replays, stats.batches) != (2, 3, 3):
            raise AssertionError(f"{graphs.captures} captures, {graphs.replays} replays, "
                                 f"{stats.batches} batches; expected 2, 3, 3")
        per_batch = ({"alt_corr": 1, "fused_update": iters - 1} if fused
                     else {"alt_corr": iters, "fused_update": 0})
        per_batch["packed_conv"] = K3_PER_TRUNK if packed else 0
        want = {k: 3 * n for k, n in per_batch.items()}
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected {want}")
        if wrapper != {k: 2 * 2 * n for k, n in per_batch.items()}:  # 2 x (warm-up + capture)
            raise AssertionError(f"wrapper counts {wrapper}")
        outs = []
        for k, (H, W) in enumerate(shapes):
            disp = np.load(out / f"pair{k}.npy")
            if disp.shape != (H, W) or not np.isfinite(disp).all():
                raise AssertionError(f"pair{k}: disparity {disp.shape}")
            outs.append(disp)

        with _launches_kept():
            imgs = [(load_image(str(data / f"pair{k}" / "im0.png"))[0],
                     load_image(str(data / f"pair{k}" / "im1.png"))[0]) for k in range(n_pairs)]
            # the first batch (pairs 0-3, bucket 544x960) as served, against
            # an eager run of the same batch; then each of its pairs alone
            padder = BatchPadder([shapes[k] for k in range(ENGINE_BATCH)], divis_by=32)
            a, b = (torch.from_numpy(padder.pad([imgs[k][s] for k in range(ENGINE_BATCH)])).cuda()
                    for s in (0, 1))
            eager = {n: model(a, b, iters=n)[1].cpu().numpy() for n in (iters, 1)}
            replay_equal = all(np.array_equal(padder.unpad(eager[iters], k)[:, :, 0], outs[k])
                               for k in range(ENGINE_BATCH))
            diffs = {iters: [], 1: []}
            alone, at_one_alone = [], []  # each pair's padder and inputs; its 1-iteration output
            for k in range(ENGINE_BATCH):
                i1, i2 = imgs[k]
                ip = InputPadder(i1[None].shape, divis_by=32)
                p1, p2 = (torch.from_numpy(x).cuda() for x in ip.pad(i1[None], i2[None]))
                alone.append((ip, p1, p2))
                for n in diffs:
                    single = ip.unpad(model(p1, p2, iters=n)[1])[0].cpu().numpy()
                    diffs[n].append(np.abs(single - padder.unpad(eager[n], k)))
                    if n == 1:
                        at_one_alone.append(single)
            # planted routing faults, read at one iteration: each pair
            # against the next slot's window (a rolled batch) and against
            # its own slot's window two rows down (540 rows carry a top pad
            # of 2: a wrong unpad offset); the held limit must see both
            shifted = np.roll(eager[1], -2, axis=1)
            faults = {
                "rolled_batch": _diff_stats(
                    [np.abs(at_one_alone[k] - padder.unpad(eager[1], (k + 1) % ENGINE_BATCH))
                     for k in range(ENGINE_BATCH)]),
                "unpad_off_by_2_rows": _diff_stats(
                    [np.abs(at_one_alone[k] - padder.unpad(shifted, k))
                     for k in range(ENGINE_BATCH)]),
            }
            # the witness for the gap's cause: the same one-iteration
            # comparison with cuDNN off (PyTorch's own convs, which loop
            # over the batch an item at a time)
            with torch.backends.cudnn.flags(enabled=False):
                b4 = model(a, b, iters=1)[1].cpu().numpy()
                no_cudnn = [np.abs(ip.unpad(model(p1, p2, iters=1)[1])[0].cpu().numpy()
                                   - padder.unpad(b4, k))
                            for k, (ip, p1, p2) in enumerate(alone)]
            # the engine over the same pairs in memory: captured (the demo's
            # engine, whose graphs exist) against eager, in turns
            requests = [InferRequest(payload=k, inputs=imgs[k]) for k in range(n_pairs)]
            eager_engine = InferenceEngine(engine.forward_fn, device=engine.device,
                                           batch=ENGINE_BATCH, capture=False)
            rates = {"eager": [], "captured": []}
            for kind in ("eager", "captured", "captured", "eager"):
                rates[kind] += _engine_pairs_per_s(
                    engine if kind == "captured" else eager_engine, requests, reps=1)
            torch.cuda.synchronize()
    finally:
        extractor._ENABLE_PACKED = saved
    at_depth, at_one = _diff_stats(diffs[iters]), _diff_stats(diffs[1])
    res = {
        "phase": name, "entry": "raft_stereo_tpu_torch.demo.main (engine)", "preset": preset,
        "fused_update": fused, "packed_stage": packed, "pairs": n_pairs,
        "inputs": [[n, H, W] for n, H, W in ENGINE_PAIRS], "batch": ENGINE_BATCH,
        "iters": iters, "buckets": {f"{h}x{w}": n for (h, w), n in buckets.items()},
        "launches": launches, "launches_counted_as": "launches at capture x replays",
        "launches_per_graph": per_graph, "wrapper_launches_warmup_and_capture": wrapper,
        "capture_s_per_key": demo_stats["capture_s"] / demo_stats["captures"],
        "demo": demo_stats, "demo_wall_s_with_model_build": wall,
        "engine_pairs_per_s": rates,
        "engine_ms_per_pair": {k: [1e3 / r for r in v] for k, v in rates.items()},
        "max_memory_allocated_bytes": peak,
        "replay_equals_eager_bitwise": replay_equal,
        "batched_vs_per_image_1_iter": at_one, f"batched_vs_per_image_{iters}_iters": at_depth,
        "batched_vs_per_image_1_iter_cudnn_off": _diff_stats(no_cudnn),
        "planted_faults_1_iter": faults, "tol_1_iter": ENGINE_PER_IMAGE_TOL, "card": smi_line(),
    }
    emit(res)
    if not replay_equal:
        raise AssertionError(f"{name}: the served batch differs from an eager run of it")
    if any(at_one[k] > v for k, v in ENGINE_PER_IMAGE_TOL.items()):
        raise AssertionError(f"{name}: batched vs per-image at one iteration {at_one} beyond "
                             f"{ENGINE_PER_IMAGE_TOL}")
    unseen = [f for f, st in faults.items()
              if all(st[k] <= v for k, v in ENGINE_PER_IMAGE_TOL.items())]
    if unseen:
        raise AssertionError(f"{name}: ENGINE_PER_IMAGE_TOL passes the planted faults {unseen}")
    return res


# evaluate_eth3d: the engine's metrics at batch 4 against the per-image
# path's, on the same model and data, relative to the per-image value. They
# differ as batched and per-image disparities do (ENGINE_PER_IMAGE_TOL's
# note): over the tree's 1.9 million pixels the EPE moved by 0.32% in the
# first measurement on the card, the D1 by 0.008 of its 99.7 points
# (8e-5); held to about six times each. With random weights the EPE is
# some 208 px and the D1 99.7%, so this check cannot see a routing fault
# (another pair's output scores about the same); the strong check is the
# one at batch 1, where the engine must give the per-image metrics exactly
# (the same forward at the same batch).
EVAL_TOL = {"eth3d-epe": 0.02, "eth3d-d1": 5e-4}
ETH3D_SCENES = ((4, 480, 720), (2, 400, 640))


def _eth3d_tree(tmp: Path, name: str = "eth3d", scenes=None) -> Path:
    """A synthetic tree in ETH3D's layout under ``tmp/name`` (written once,
    with the port's ``frame_io``: ``scenes``, ETH3D_SCENES by default, ground
    truth each scene's constant disparity); returns its root."""
    import numpy as np

    from raft_stereo_tpu_torch.data import frame_io

    root = tmp / name
    base = root / "datasets" / "ETH3D"
    if base.exists():
        return root
    first = 0
    for n, H, W in scenes or ETH3D_SCENES:
        disps = _write_pairs(base / "two_view_training", n, H, W, seed=SEED + 20 + first,
                             first=first)
        for k, d in enumerate(disps, start=first):
            gt = base / "two_view_training_gt" / f"pair{k}"
            gt.mkdir(parents=True)
            frame_io.write_pfm(str(gt / "disp0GT.pfm"), np.full((H, W), float(d), np.float32))
        first += n
    return root


def phase_evaluate_eth3d(tmp: Path, preset: str = "raftstereo-middlebury", iters: int = 32):
    """``evaluate.main --dataset eth3d`` on a synthetic tree in ETH3D's
    layout (written with the port's ``frame_io``: 4 scenes at 480x720 and 2
    at 400x640, ground truth each scene's constant disparity) through the
    engine at batch 4 and at batch 1, and with ``--per_image``; the batch-4
    metrics within EVAL_TOL of the per-image ones (relative), the batch-1
    ones equal."""
    import os

    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.runtime import infer

    root = _eth3d_tree(tmp)
    first = sum(n for n, _, _ in ETH3D_SCENES)
    argv = ["--dataset", "eth3d", "--preset", preset, "--valid_iters", str(iters)]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with _launches_kept():
            t0 = time.perf_counter()
            engine = evaluate.main(argv)
            t1 = time.perf_counter()
            summary = infer.last_summary()
            engine_b1 = evaluate.main(argv + ["--infer_batch", "1"])
            t2 = time.perf_counter()
            per_image = evaluate.main(argv + ["--per_image"])
            t3 = time.perf_counter()
    finally:
        os.chdir(cwd)
    diff = {k: abs(engine[k] - per_image[k]) / abs(per_image[k]) for k in EVAL_TOL}
    res = {"phase": "evaluate_eth3d", "entry": "raft_stereo_tpu_torch.evaluate.main",
           "preset": preset, "iters": iters, "scenes": first, "engine_batch4": engine,
           "engine_batch1": engine_b1, "per_image": per_image, "rel_diff_batch4": diff,
           "tol": EVAL_TOL, "batch1_equal": engine_b1 == per_image,
           "engine_summary": {"completed": summary.completed, "failed": summary.failed},
           "wall_s": {"engine_batch4": t1 - t0, "engine_batch1": t2 - t1,
                      "per_image": t3 - t2}}
    emit(res)
    if summary.completed != first or summary.failed:
        raise AssertionError(f"evaluate_eth3d: engine served {summary}")
    if engine_b1 != per_image:
        raise AssertionError(f"evaluate_eth3d: engine at batch 1 {engine_b1} vs per-image "
                             f"{per_image}")
    if any(not math.isfinite(engine[k]) or diff[k] > EVAL_TOL[k] for k in EVAL_TOL):
        raise AssertionError(f"evaluate_eth3d: engine {engine} vs per-image {per_image}")
    return res


# ------------------------------------------------ engine faults, telemetry

# The engine's fault runs: the realtime-packed engine cell (ENGINE_PAIRS,
# batch 4, 7 iterations, bf16), each run on a fresh engine with one injector
# set in the environment. FAULT_DEADLINE_S bounds every wait of the hang
# run; RUN_LIMIT_S bounds each run's wall time, captures included, and
# HANG_SLACK_S what the hang run may take past its deadline (its captures
# and the other batches: under a second on an H100).
FAULT_DEADLINE_S = 3.0
RUN_LIMIT_S = 120.0
HANG_SLACK_S = 30.0
FAULT_RUNS = (
    # name, injector env var, value, the injector's implied counts
    ("decode_fail", "RAFT_FI_INFER_DECODE_FAIL", "3",
     {"completed": 8, "failed": 1, "degraded": 0, "retries": 0, "circuits_open": 0,
      "watchdog_trips": 0}),
    ("capture_fail_once", "RAFT_FI_INFER_COMPILE_FAIL", "1",
     {"completed": 9, "failed": 0, "degraded": 0, "retries": 1, "circuits_open": 0,
      "watchdog_trips": 0}),
    ("capture_fail_always", "RAFT_FI_INFER_COMPILE_FAIL", ",".join(map(str, range(1, 31))),
     {"completed": 9, "failed": 0, "degraded": 3, "retries": 4, "circuits_open": 2,
      "watchdog_trips": 0}),
    ("oom", "RAFT_FI_INFER_OOM", "4",
     {"completed": 9, "failed": 0, "degraded": 3, "retries": 0, "circuits_open": 0,
      "watchdog_trips": 0}),
    ("hang", "RAFT_FI_INFER_HANG", "1",
     {"completed": 5, "failed": 4, "degraded": 0, "retries": 0, "circuits_open": 0,
      "watchdog_trips": 1}),
)

# Captures that break midway, planted in the model's forward (not the
# injector, which fires before a capture begins): each fires once, while the
# stream captures the 480x640 bucket's batch-4 graph, after the 544x960
# bucket's graph, and so the engine's shared graph pool, already exists. A
# raise; a host read-back, which CUDA refuses while the stream captures and
# which invalidates the capture; a real allocator OOM. The first two must
# be retried (one retry, the recaptured graph bitwise the clean batch-4
# run); the OOM must halve that bucket to batch 2 (its pairs bitwise the
# clean batch-2 run, the other bucket's the batch-4 run). The raise and the
# OOM must keep the pool the first graph made; after the read-back the
# retried capture must take a fresh pool (the spoiled one refuses it).
CAPTURE_BREAK_BUCKET = (480, 640)
CAPTURE_BREAK_RUNS = (
    # name, what breaks, the implied counts, whether the first pool is kept
    ("capture_raise", "raise",
     {"completed": 9, "failed": 0, "degraded": 0, "retries": 1, "circuits_open": 0,
      "watchdog_trips": 0}, True),
    ("capture_readback", "readback",
     {"completed": 9, "failed": 0, "degraded": 0, "retries": 1, "circuits_open": 0,
      "watchdog_trips": 0}, False),
    ("capture_oom_real", "oom",
     {"completed": 9, "failed": 0, "degraded": 1, "retries": 0, "circuits_open": 0,
      "watchdog_trips": 0}, True),
)


@contextlib.contextmanager
def _capture_break(model, kind: str, seen: dict):
    """Plant ``kind`` in ``model``'s forward for the block: it fires once,
    while the stream captures a batch-4 graph of CAPTURE_BREAK_BUCKET, and
    records in ``seen`` the engine's graph pool and entries at that moment
    (``seen["engine"]`` is set by the caller)."""
    import torch

    forward = model.forward

    def breaking(a, b, *args, **kw):
        out = forward(a, b, *args, **kw)
        if (not seen.get("fired") and torch.cuda.is_current_stream_capturing()
                and a.shape[0] == 4 and tuple(a.shape[1:3]) == CAPTURE_BREAK_BUCKET):
            graphs = seen["engine"].graphs
            seen.update(fired=True, pool=graphs._pool, entries=len(graphs))
            try:
                if kind == "raise":
                    raise RuntimeError("planted: raised while the stream captures")
                if kind == "readback":
                    a.sum().item()
                if kind == "oom":
                    torch.empty(1 << 50, dtype=torch.uint8, device=a.device)
            except Exception as e:
                seen["error"] = f"{type(e).__name__}: {e}"[:300]
                raise
            seen["error"] = None  # the planted fault did not raise
        return out

    model.forward = breaking
    try:
        yield
    finally:
        del model.forward


@contextlib.contextmanager
def _injector(name=None, value=None):
    """Set one fault injector's environment variable for the block; reset
    the injection counters (and release a parked hang) on both sides."""
    import os

    from raft_stereo_tpu_torch.runtime import faultinject

    faultinject.reset()
    if name is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        if name is not None:
            os.environ.pop(name, None)
        faultinject.reset()


def _engine_pairs(tmp: Path):
    """ENGINE_PAIRS as host arrays (the engine phases' PNGs, decoded)."""
    from raft_stereo_tpu_torch.demo import load_image

    data = tmp / "engine_pairs"
    if not data.exists():
        first = 0
        for n, H, W in ENGINE_PAIRS:
            _write_pairs(data, n, H, W, seed=SEED + first, first=first)
            first += n
    n_pairs = sum(n for n, _, _ in ENGINE_PAIRS)
    return [(load_image(str(data / f"pair{k}" / "im0.png"))[0],
             load_image(str(data / f"pair{k}" / "im1.png"))[0]) for k in range(n_pairs)]


def _realtime_packed_model():
    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model

    return load_model(PRESETS["raftstereo-realtime"], seed=SEED)


def _serve_once(model, imgs, batch, deadline_s=None, retries=2, seen=None):
    """A fresh engine over ``imgs``: (engine, results by payload, wall s,
    summary). The stream's end is held to RUN_LIMIT_S. ``seen["engine"]``,
    when given, is the engine, set before the stream starts."""
    import gc

    import torch

    from raft_stereo_tpu_torch.evaluate import make_engine
    from raft_stereo_tpu_torch.runtime import infer

    engine = make_engine(model, 7, infer.InferOptions(batch=batch, deadline_s=deadline_s,
                                                      retries=retries))
    if seen is not None:
        seen["engine"] = engine
    requests = [infer.InferRequest(payload=k, inputs=p) for k, p in enumerate(imgs)]
    t0 = time.perf_counter()
    results = {r.payload: r for r in engine.stream(iter(requests))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = infer.publish_summary(engine.stats, label=f"engine batch {batch}")
    gc.collect()
    if wall > RUN_LIMIT_S:
        raise AssertionError(f"an engine run took {wall:.1f}s, past {RUN_LIMIT_S}s")
    return engine, results, wall, summary


def _eager_per_image(model, imgs, iters=7):
    """Each pair alone through the eager forward (batch 1, padded by the
    per-image padder): the degraded path's reference."""
    import torch

    from raft_stereo_tpu_torch.ops.pad import InputPadder

    out = {}
    for k, (i1, i2) in enumerate(imgs):
        ip = InputPadder(i1[None].shape, divis_by=32)
        p1, p2 = (torch.from_numpy(x).cuda() for x in ip.pad(i1[None], i2[None]))
        out[k] = ip.unpad(model(p1, p2, iters=iters)[1])[0].cpu().numpy()
    return out


def _outputs_equal(results, want) -> dict:
    """Each completed result against ``want`` (by payload), bitwise."""
    import numpy as np

    done = [k for k, r in results.items() if r.ok]
    return {"compared": len(done),
            "bitwise_equal": sum(int(np.array_equal(results[k].output, want[k])) for k in done)}


def phase_engine_faults(tmp: Path):
    """The engine's fault tolerance on the card, on the realtime-packed
    engine cell: one clean run, then one run for each injector on a fresh
    engine (FAULT_RUNS): a failed decode fails its request alone; a capture
    that fails once is retried; a capture that always fails opens each
    bucket's circuit and the pairs are served one at a time by the eager
    per-image path, on the card, through K1 and K3 (their launch counts
    must move); an OOM at batch 4 halves each batch to 2, and the cap is
    kept; a hung device wait trips the watchdog after FAULT_DEADLINE_S, its
    batch fails and the stream ends. Each run's counts must be as its
    injector implies, and every completed output must equal, bitwise, a
    clean run at the same effective batch size: batch 4, batch 2 (the
    halved runs) or the eager per-image forward (the circuit run)."""
    import gc

    import torch

    from raft_stereo_tpu_torch.models import extractor

    imgs = _engine_pairs(tmp)
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    runs, paths = {}, []
    try:
        model = _realtime_packed_model()
        with _launches_kept(), _injector():
            _, clean4, wall4, s4 = _serve_once(model, imgs, 4)
            _, clean2, wall2, s2 = _serve_once(model, imgs, 2)
            per_image = _eager_per_image(model, imgs)
        want = {"batch4": {k: r.output for k, r in clean4.items()},
                "batch2": {k: r.output for k, r in clean2.items()}, "per_image": per_image}
        runs["clean"] = {"batch4": {"completed": s4.completed, "wall_s": wall4},
                         "batch2": {"completed": s2.completed, "wall_s": wall2}}
        for name, var, value, expect in FAULT_RUNS:
            deadline = FAULT_DEADLINE_S if name == "hang" else None
            with _injector(var, value):
                _zero_launches()
                engine, results, wall, s = _serve_once(model, imgs, 4, deadline_s=deadline)
                launches = _launches()
            st = engine.stats
            got = {"completed": s.completed, "failed": s.failed, "degraded": s.degraded,
                   "retries": st.retries, "circuits_open": st.circuits_open,
                   "watchdog_trips": s.watchdog_trips}
            ref = ("per_image" if name == "capture_fail_always"
                   else "batch2" if name == "oom" else "batch4")
            run = {"injector": f"{var}={value if len(value) < 8 else '1..30'}", "counts": got,
                   "expected": expect, "wall_s": wall, "launches": launches,
                   "bucket_caps": {f"{b[0]}x{b[1]}": c for b, c in engine._bucket_cap.items()},
                   "broken_buckets": sorted(f"{b[0]}x{b[1]}" for b in engine._broken),
                   "failed_payloads": sorted(k for k, r in results.items() if not r.ok),
                   "errors": sorted({type(r.error).__name__ for r in results.values()
                                     if not r.ok}),
                   "reference": ref, **_outputs_equal(results, want[ref])}
            runs[name] = run
            if name == "capture_fail_always":
                paths.append({"phase": "engine_faults_degraded", "launches": launches})
            del engine, results
            gc.collect()
            torch.cuda.empty_cache()
        # payloads of CAPTURE_BREAK_BUCKET: the last ENGINE_PAIRS entry's
        broken = set(range(ENGINE_PAIRS[0][0], len(imgs)))
        for name, kind, expect, _ in CAPTURE_BREAK_RUNS:
            seen: dict = {}
            with _injector(), _launches_kept(), _capture_break(model, kind, seen):
                engine, results, wall, s = _serve_once(model, imgs, 4, seen=seen)
            st, graphs = engine.stats, engine.graphs
            got = {"completed": s.completed, "failed": s.failed, "degraded": s.degraded,
                   "retries": st.retries, "circuits_open": st.circuits_open,
                   "watchdog_trips": s.watchdog_trips}
            ref = {k: want["batch2" if kind == "oom" and k in broken else "batch4"][k]
                   for k in want["batch4"]}
            runs[name] = {
                "planted": kind, "counts": got, "expected": expect, "wall_s": wall,
                "fired": bool(seen.get("fired")), "error": seen.get("error"),
                "entries_when_it_broke": seen.get("entries"),
                "pool_when_it_broke": seen.get("pool") is not None,
                "pool_kept": graphs._pool == seen.get("pool"),
                "graphs": sorted(f"{k[0][0]}x{k[0][1]}x{k[1]}" for k, _ in graphs.items()),
                "captures": graphs.captures, "misses": graphs.misses,
                "bucket_caps": {f"{b[0]}x{b[1]}": c for b, c in engine._bucket_cap.items()},
                "errors": sorted({type(r.error).__name__ for r in results.values()
                                  if not r.ok}),
                "reference": "batch2 (480x640), batch4" if kind == "oom" else "batch4",
                **_outputs_equal(results, ref)}
            del engine, results, graphs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        extractor._ENABLE_PACKED = saved
    n_pairs = len(imgs)
    res = {"phase": "engine_faults", "preset": "raftstereo-realtime", "packed_stage": True,
           "iters": 7, "batch": 4, "inputs": [[n, H, W] for n, H, W in ENGINE_PAIRS],
           "deadline_s_hang_run": FAULT_DEADLINE_S, "run_limit_s": RUN_LIMIT_S, "runs": runs,
           "card": smi_line()}
    emit(res)
    if runs["clean"]["batch4"]["completed"] != n_pairs or runs["clean"]["batch2"]["completed"] \
            != n_pairs:
        raise AssertionError(f"engine_faults: the clean runs {runs['clean']}")
    for name, _, _, expect in FAULT_RUNS:
        r = runs[name]
        if r["counts"] != expect:
            raise AssertionError(f"engine_faults {name}: counts {r['counts']}, expected {expect}")
        if r["bitwise_equal"] != r["compared"] or r["compared"] != expect["completed"]:
            raise AssertionError(f"engine_faults {name}: {r['bitwise_equal']} of "
                                 f"{r['compared']} outputs equal the {r['reference']} run")
    deg = runs["capture_fail_always"]
    want_launches = {"alt_corr": 7 * n_pairs, "fused_update": 0,
                     "packed_conv": K3_PER_TRUNK * n_pairs}
    if deg["launches"] != want_launches or len(deg["broken_buckets"]) != 2:
        raise AssertionError(f"engine_faults: the per-image path launched {deg['launches']}, "
                             f"expected {want_launches}; broken {deg['broken_buckets']}")
    if runs["oom"]["bucket_caps"] != {"544x960": 2, "480x640": 2}:
        raise AssertionError(f"engine_faults: OOM caps {runs['oom']['bucket_caps']}")
    if runs["hang"]["failed_payloads"] != [0, 1, 2, 3] or runs["decode_fail"][
            "failed_payloads"] != [2]:
        raise AssertionError("engine_faults: the wrong requests failed")
    for name, kind, expect, pool_kept in CAPTURE_BREAK_RUNS:
        r = runs[name]
        graphs = ["480x640x2", "544x960x4"] if kind == "oom" else ["480x640x4", "544x960x4"]
        if not (r["fired"] and r["error"] and r["entries_when_it_broke"] == 1
                and r["pool_when_it_broke"] and r["pool_kept"] == pool_kept):
            raise AssertionError(f"engine_faults {name}: fired {r['fired']} ({r['error']}), "
                                 f"entries when it broke {r['entries_when_it_broke']}, pool "
                                 f"kept {r['pool_kept']} (expected {pool_kept})")
        if r["counts"] != expect or r["graphs"] != graphs or r["captures"] != 2:
            raise AssertionError(f"engine_faults {name}: counts {r['counts']} (expected "
                                 f"{expect}), graphs {r['graphs']}, {r['captures']} captures")
        if r["bitwise_equal"] != r["compared"] or r["compared"] != n_pairs:
            raise AssertionError(f"engine_faults {name}: {r['bitwise_equal']} of "
                                 f"{r['compared']} outputs equal the {r['reference']} run")
    if runs["hang"]["wall_s"] > FAULT_DEADLINE_S + HANG_SLACK_S:
        raise AssertionError(f"engine_faults: the hang run took {runs['hang']['wall_s']:.1f}s "
                             f"against a {FAULT_DEADLINE_S}s deadline")
    return res, paths


def phase_engine_oom_real(tmp: Path):
    """The OOM halving driven by the allocator, not the injector: the
    realtime-packed engine over the 6 pairs of the 544x960 bucket. A clean
    engine's ``max_memory_allocated`` at batch 4 and at batch 2, then the
    process's memory fraction set halfway between the two and a fresh
    engine at batch 4: a real ``torch.cuda.OutOfMemoryError`` must halve the
    batch to 2 (an ``infer_degraded`` event with reason ``oom``), every
    request must complete and equal the clean batch-2 run bitwise. The
    fraction is restored in ``finally``."""
    import gc

    import torch

    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.runtime import telemetry

    imgs = _engine_pairs(tmp)[:ENGINE_PAIRS[0][0]]
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    total = torch.cuda.get_device_properties(0).total_memory
    tel_dir = tmp / "oom_real_telemetry"
    try:
        model = _realtime_packed_model()
        peaks, clean = {}, {}
        with _launches_kept(), _injector():
            for b in (4, 2):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                engine, results, _, _ = _serve_once(model, imgs, b)
                peaks[b] = torch.cuda.max_memory_allocated()
                clean[b] = {k: r.output for k, r in results.items()}
                del engine, results
            gc.collect()
            torch.cuda.empty_cache()
            limit = (peaks[4] + peaks[2]) // 2
            torch.cuda.set_per_process_memory_fraction(limit / total)
            tel = telemetry.install(telemetry.Telemetry(str(tel_dir)))
            try:
                torch.cuda.reset_peak_memory_stats()
                engine, results, wall, s = _serve_once(model, imgs, 4)
                peak_limited = torch.cuda.max_memory_allocated()
                reserved_limited = torch.cuda.max_memory_reserved()
            finally:
                telemetry.uninstall(tel)
            caps = {f"{b[0]}x{b[1]}": c for b, c in engine._bucket_cap.items()}
            eq = _outputs_equal(results, clean[2])
            del engine, results
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        extractor._ENABLE_PACKED = saved
        gc.collect()
        torch.cuda.empty_cache()
    events = [json.loads(ln) for ln in (tel_dir / "events.jsonl").read_text().splitlines()]
    degraded = [e for e in events if e["event"] == "infer_degraded"]
    res = {"phase": "engine_oom_real", "preset": "raftstereo-realtime", "packed_stage": True,
           "pairs": len(imgs), "shape": [540, 960],
           "max_memory_allocated_bytes": {"batch4": peaks[4], "batch2": peaks[2],
                                          "limit_halfway": limit,
                                          "fraction_run_peak": peak_limited,
                                          "fraction_run_peak_reserved": reserved_limited},
           "fraction": limit / total, "card_memory_bytes": total,
           "summary": {"completed": s.completed, "failed": s.failed, "degraded": s.degraded},
           "bucket_caps": caps,
           "degraded_events": [{k: e.get(k) for k in ("reason", "micro_batch", "error")}
                               for e in degraded],
           "wall_s": wall, "reference": "batch2", **eq, "card": smi_line()}
    emit(res)
    print(f"engine_oom_real: max_memory_allocated batch 4 {peaks[4]} B, batch 2 {peaks[2]} B, "
          f"limit {limit} B ({smi_line()})", flush=True)
    real = [e for e in degraded if e["reason"] == "oom"
            and str(e.get("error", "")).startswith("OutOfMemoryError")]
    if not real or real[0]["micro_batch"] != 2:
        raise AssertionError(f"engine_oom_real: no real OOM halved the batch to 2: {degraded}")
    if caps != {"544x960": 2} or s.completed != len(imgs) or s.failed:
        raise AssertionError(f"engine_oom_real: caps {caps}, summary {res['summary']}")
    if eq["bitwise_equal"] != len(imgs):
        raise AssertionError(f"engine_oom_real: {eq} outputs equal the clean batch-2 run")
    return res


def phase_telemetry_cost(tmp: Path, rounds: int = 2):
    """The engine_path_realtime_packed cell's pairs/s (captured engine,
    batch 4, the cell's 9 pairs in memory) with no telemetry sink installed
    and with one, in turns (none, sink, sink, none), ``rounds`` times, each
    stream the 9 pairs STREAM_REPEAT times over: ``tools/engine_overhead.py``'s
    ``stream_rates``, which also times another checkout's engine against
    this one. Every request must complete."""
    from raft_stereo_tpu_torch.evaluate import make_engine
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.runtime import infer
    from tools.engine_overhead import ROUND, STREAM_REPEAT, spread, stream_rates

    imgs = _engine_pairs(tmp)
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    try:
        model = _realtime_packed_model()
        engine = make_engine(model, 7, infer.InferOptions(batch=ENGINE_BATCH))
        requests = [infer.InferRequest(payload=k, inputs=p)
                    for k, p in enumerate(imgs * STREAM_REPEAT)]
        with _launches_kept():
            list(engine.stream(iter(requests[:len(imgs)])))  # captures
            rates = stream_rates({"none": (engine, requests, False),
                                  "sink": (engine, requests, True)}, ROUND[1:-1], rounds,
                                 str(tmp / "cost_telemetry"))
    finally:
        extractor._ENABLE_PACKED = saved
    med = {m: spread(v)["median"] for m, v in rates.items()}
    res = {"phase": "telemetry_cost", "cell": "engine_path_realtime_packed",
           "pairs_a_stream": len(requests), "pairs_per_s": rates, "median_pairs_per_s": med,
           "sink_over_none": med["sink"] / med["none"], "card": smi_line()}
    emit(res)
    print(f"telemetry_cost: engine_path_realtime_packed pairs/s, no sink {med['none']:.2f}, "
          f"sink {med['sink']:.2f} ({smi_line()})", flush=True)
    return res


def _check_run_dir(run_dir: Path, want_memory: bool) -> dict:
    """A telemetry run directory on disk: events.jsonl, heartbeat.json,
    metrics.prom and trace_host.json exist and parse; every event names a
    declared schema entry, carries the framing keys and only declared
    payload keys; ``tools/run_report.py`` reads the directory (exit 0)."""
    from raft_stereo_tpu_torch.runtime import telemetry

    events = [json.loads(ln) for ln in (run_dir / "events.jsonl").read_text().splitlines()
              if ln.strip()]
    heartbeat = json.loads((run_dir / "heartbeat.json").read_text())
    trace = json.loads((run_dir / "trace_host.json").read_text())
    prom = (run_dir / "metrics.prom").read_text()
    bad = []
    for e in events:
        declared = telemetry.EVENT_SCHEMA.get(e.get("event"))
        framing = {"event", "t_wall", "t_mono", "host"}
        if declared is None or not framing <= set(e) or not (
                set(e) <= set(declared) | telemetry.RESERVED_KEYS):
            bad.append(e)
    report = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "tools"
                                                 / "run_report.py"), str(run_dir)],
                            capture_output=True, text=True, timeout=120)
    out = {"events": len(events), "event_names": sorted({e["event"] for e in events}),
           "undeclared_or_malformed": bad[:5], "heartbeat_keys": sorted(heartbeat),
           "device_memory": heartbeat.get("device_memory"),
           "trace_spans": trace.get("otherData", {}).get("spans"),
           "metrics_prom_lines": len(prom.splitlines()), "run_report_rc": report.returncode,
           "run_report_head": report.stdout.splitlines()[:3]}
    if bad or report.returncode != 0 or not events or not out["trace_spans"]:
        raise AssertionError(f"telemetry run dir {run_dir}: {out}; {report.stderr[-400:]}")
    if want_memory and not (out["device_memory"] or {}).get("peak_bytes_in_use"):
        raise AssertionError(f"telemetry run dir {run_dir}: no card memory in the heartbeat")
    return out


def phase_telemetry_runs(tmp: Path):
    """The CLIs with telemetry on: ``evaluate.main --dataset eth3d
    --telemetry_dir`` (the realtime preset through the engine) on the
    synthetic ETH3D tree, and ``train.main --telemetry --profile_steps 2:3``
    for 3 steps of the train_path recipe; each run directory is checked
    (``_check_run_dir``), the training one with the card's memory in its
    heartbeat and a torch.profiler trace of steps 2-3."""
    from raft_stereo_tpu_torch import evaluate, train

    root = _eth3d_tree(tmp)
    eval_dir = tmp / "telemetry_eval"
    with _chdir(root), _launches_kept():
        metrics = evaluate.main(["--dataset", "eth3d", "--preset", "raftstereo-realtime",
                                 "--valid_iters", "7", "--telemetry_dir", str(eval_dir)])
    res = {"phase": "telemetry_runs", "evaluate": {"metrics": metrics,
                                                   **_check_run_dir(eval_dir, True)}}
    train_root = tmp / "train"
    if not (train_root / "datasets").exists():
        _write_things_tree(train_root)
    argv = ["--name", "telemetry_run", "--train_datasets", "sceneflow", "--num_steps", "3",
            *TRAIN_RECIPE, "--telemetry", "--profile_steps", "2:3"]
    with _chdir(train_root), _launches_kept():
        result = train.main(argv)
    run_dir = train_root / "runs" / "telemetry_run"
    traces = sorted(str(p.relative_to(run_dir)) for p in (run_dir / "profile").glob("*.json"))
    res["train"] = {"steps": result.total_steps, "profile_traces": traces,
                    **_check_run_dir(run_dir, True)}
    emit(res)
    if result.total_steps != 3 or not traces:
        raise AssertionError(f"telemetry_runs: train {res['train']}")
    for want in ("run_start", "run_end", "checkpoint_commit", "profile_start", "profile_stop"):
        if want not in res["train"]["event_names"]:
            raise AssertionError(f"telemetry_runs: the training run wrote no {want}")
    for want in ("bucket_compile", "infer_batch_commit", "stream_summary"):
        if want not in res["evaluate"]["event_names"]:
            raise AssertionError(f"telemetry_runs: the evaluate run wrote no {want}")
    return res


@contextlib.contextmanager
def _determinism(level: str):
    """``none``, or ``cudnn``: cuDNN's deterministic algorithms for the
    block, restored afterwards."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = saved or level == "cudnn"
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _k2_grad_check():
    """K2's gradient at the slice shape ([1, 136, 240, 256], 4 levels,
    radius 4, with inp16), bf16 and fp32: ``fused_refine_step`` with the
    kernel forward (its autograd Function recomputes the plain version in
    its backward) against the plain version's own autograd, bitwise, for
    every input that takes a gradient (fmap1, each level, h, inp16, ctx,
    each packed weight); ``flow_x`` must get none. The plain autograd runs
    twice first: where the two differ, the check runs again with cuDNN's
    deterministic algorithms, and says whether it needed them. The backward (``fused_step_vjp``) is timed with CUDA events.
    Returns the check and the kernel-forward run's launch counts."""
    import torch

    from raft_stereo_tpu_torch.ops import fused_update

    cases, launches = [], None
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        _, args = _fused_inputs(1, 136, 240, 256, 4, 4, True, dtype, seed=SEED + 46)
        packed, f1, pyr, flow, h, inp, ctx, radius = args
        g = torch.Generator(device="cuda").manual_seed(SEED + 47)
        gh = torch.randn(h.shape, generator=g, device="cuda").to(dtype)
        gd = torch.randn(flow.shape, generator=g, device="cuda")
        n_lv = len(pyr)

        def grads(step):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (f1, h, inp, ctx, *pyr, *packed.values())]
            fl = flow.detach().clone().requires_grad_(step is not fused_update.reference_refine_step)
            lp = dict(zip(packed, leaves[4 + n_lv:]))
            out = step(lp, leaves[0], leaves[4:4 + n_lv], fl, leaves[1], leaves[2], leaves[3],
                       radius, dtype)
            torch.autograd.backward(out, (gh, gd))
            torch.cuda.synchronize()
            return [t.grad for t in leaves], fl.grad

        def equal(a, b):
            return all(torch.equal(x, y) for x, y in zip(a, b))

        level = None
        for lvl in ("none", "cudnn"):
            with _determinism(lvl):
                p1, _ = grads(fused_update.reference_refine_step)
                p2, _ = grads(fused_update.reference_refine_step)
                if not equal(p1, p2):
                    continue
                level = lvl
                _zero_launches()
                k, k_flow = grads(fused_update.fused_refine_step)
                if dname == "bfloat16":
                    launches = _launches()
                break
        names = (["fmap1", "h", "inp16", "ctx"] + [f"level{i}" for i in range(n_lv)]
                 + list(packed))
        c = {"dtype": dname, "shape": [1, 136, 240, 256], "levels": n_lv, "radius": radius,
             "determinism_needed": level}
        if level is not None:
            diff = {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in zip(names, k, p1) if not torch.equal(a, b)}
            c.update(bitwise_equal=not diff, differing=diff, flow_grad_is_none=k_flow is None,
                     grads=len(names))
            with _determinism(level):
                c["bwd_ms"] = _time_ms(lambda: fused_update.fused_step_vjp(
                    packed, f1, pyr, flow, h, inp, ctx, radius, dtype, (gh, gd), set(names)),
                    5, warmup=1)
            c["fwd_ms"] = _time_ms(lambda: fused_update.fused_refine_step(
                packed, f1, pyr, flow, h, inp, ctx, radius, compute_dtype=dtype), 20)
        cases.append(c)
        del args, packed, f1, pyr, flow, h, inp, ctx, gh, gd
        torch.cuda.empty_cache()
    return cases, launches


def _first_pair(tmp: Path):
    """The first synthetic pair, padded to /32, on the card."""
    import torch

    from raft_stereo_tpu_torch.demo import load_image
    from raft_stereo_tpu_torch.ops.pad import InputPadder

    img1 = load_image(str(tmp / "pairs" / "pair0" / "im0.png"))
    img2 = load_image(str(tmp / "pairs" / "pair0" / "im1.png"))
    p1, p2 = InputPadder(img1.shape, divis_by=32).pad(img1, img2)
    return torch.from_numpy(p1).cuda(), torch.from_numpy(p2).cuda()


@contextlib.contextmanager
def _fp32_checks():
    """TF32 off, so the plain versions' convs and matmuls run in full fp32,
    and the kernels' launch counts put back afterwards: launches made to
    compare a kernel with its plain version do not count."""
    import torch

    from raft_stereo_tpu_torch.experiments import packed_conv
    from raft_stereo_tpu_torch.ops import alt_corr, fused_update

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             alt_corr.LAUNCHES, fused_update.LAUNCHES, fused_update.MOTION_IN_LAUNCHES,
             fused_update.HEAD_OUT_LAUNCHES, packed_conv.LAUNCHES)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         alt_corr.LAUNCHES, fused_update.LAUNCHES, fused_update.MOTION_IN_LAUNCHES,
         fused_update.HEAD_OUT_LAUNCHES, packed_conv.LAUNCHES) = saved


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

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False)
    model = load_model(cfg, device="cuda", seed=SEED)
    a, b = _first_pair(tmp)
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

    runs = {}
    with _fp32_checks():
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


def phase_parity_fused(tmp: Path, iters: int = 32, iters_checked: int = 2):
    """The fp32 forward with ``fused_update`` (TF32 off) on one pair.

    (a) Along the 32 iterations, every K2 step is also run through the
    plain step on the same inputs and held to it. The flows here are not on
    a grid, so the plain lookup (one rounding of x/2^l + k per tap) and the
    kernel's (one frac per level) sample positions up to half an ulp of
    |x| + r apart, which moves a tap by up to that times the largest
    difference between neighbouring taps (``shift``, as for K1). The
    tolerance adds, to the fp32 one, ``shift`` times the step's own gain
    from taps to outputs, measured on the same inputs: the plain step with
    the flow moved by 2^-10 px, which moves every tap by up to 2^-10 times
    the same tap difference, and the flow's other uses with it.
    The same for the preset's bf16 forward, whose steps run the main path's
    instantiation of K2, each held to K2_BF16_TOL.
    (b) The fused forward is held to the unfused one after
    ``iters_checked`` iterations (PARITY_ATOL_*); random weights do not
    contract, so the difference is printed for 1, 2 and 32 iterations too.
    Returns the fp32 per-step convergence signals for the early-exit phase.
    """
    import dataclasses

    import numpy as np
    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.ops import alt_corr, fused_update
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    base = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False)
    fused_model = load_model(dataclasses.replace(base, fused_update=True), device="cuda",
                             seed=SEED)
    plain_model = load_model(base, device="cuda", seed=SEED)
    a, b = _first_pair(tmp)
    kernel_step = fused_update.fused_refine_step
    plain_step = fused_update.reference_refine_step
    steps = []
    eps_flow = 2.0 ** -10

    bf16_steps = []

    def checked_step(packed, fmap1, pyramid, flow_x, h, inp16, ctx, radius,
                     compute_dtype=torch.float32):
        args = (packed, fmap1, pyramid, flow_x, h, inp16, ctx, radius)
        got = kernel_step(*args, compute_dtype=compute_dtype)
        want = plain_step(*args, compute_dtype=compute_dtype)
        res = k2_errors(got, want, compute_dtype)
        if compute_dtype == torch.bfloat16:  # a moved tap is one more flipped rounding
            bf16_steps.append(res)
            return got
        moved = plain_step(packed, fmap1, pyramid, flow_x + eps_flow, h, inp16, ctx, radius,
                           compute_dtype=compute_dtype)
        coords = flow_x + _x_grid(flow_x)
        taps = corr_lookup_alt_plain(fmap1, pyramid, coords, radius)
        step = float(taps.unflatten(-1, (len(pyramid), 2 * radius + 1)).diff(dim=-1).abs().max())
        shift = _ulp32(float(coords.abs().max()) + radius) * step
        # gain per unit of tap movement, from the 2^-10 px move
        gain_h = float((moved[0] - want[0]).abs().max()) / (eps_flow * step)
        gain_d = float((moved[1] - want[1]).abs().max()) / (eps_flow * step)
        res["tol_h"] += gain_h * shift
        res["tol_delta"] += gain_d * shift
        res["ok"] = res["err_h"] <= res["tol_h"] and res["err_delta"] <= res["tol_delta"]
        res["lookup_shift"] = shift
        res["dnorm"] = float(fused_update.batch_max_delta((flow_x + got[1]) - flow_x))
        steps.append(res)
        return got

    runs = {}
    with _fp32_checks():
        try:
            fused_update.fused_refine_step = checked_step
            fused_model(a, b, iters=iters)
            # the preset's bf16 forward: the main path's instantiation of K2
            bf16_model = load_model(dataclasses.replace(PRESETS["raftstereo-middlebury"],
                                                        fused_update=True),
                                    device="cuda", seed=SEED)
            bf16_model(a, b, iters=iters)
            del bf16_model
            fused_update.fused_refine_step = kernel_step
            for n in (1, iters_checked, iters):
                if n in runs:
                    continue
                before = (fused_update.LAUNCHES, alt_corr.LAUNCHES)
                low_f, up_f = fused_model(a, b, iters=n)
                got = (fused_update.LAUNCHES - before[0], alt_corr.LAUNCHES - before[1])
                if got != (n - 1, 1):
                    raise AssertionError(f"fused forward launched (K2, K1) {got}, expected {(n - 1, 1)}")
                low_p, up_p = plain_model(a, b, iters=n)
                runs[n] = [t.cpu().numpy() for t in (low_f, low_p, up_f, up_p)]
        finally:
            fused_update.fused_refine_step = kernel_step
    growth = {}
    for n, (lf, lp, uf, up) in runs.items():
        if not (np.isfinite(uf).all() and np.isfinite(up).all()):
            raise AssertionError(f"non-finite disparity in the fused parity forwards at {n} iterations")
        growth[str(n)] = {"max_abs_err_lowres": float(np.abs(lf - lp).max()),
                          "max_abs_err_up": float(np.abs(uf - up).max()),
                          "max_abs_disp": float(np.abs(up).max())}
    lf, lp, uf, up = runs[iters_checked]
    worst = max(steps, key=lambda x: max(x["err_h"] / x["tol_h"], x["err_delta"] / x["tol_delta"]))
    res = {"phase": "parity_fused", "dtype": "float32", "cudnn_allow_tf32": False,
           "matmul_allow_tf32": False, "shape": list(uf.shape), "steps_checked": len(steps),
           "step_max_err_h": max(x["err_h"] for x in steps),
           "step_max_err_delta": max(x["err_delta"] for x in steps),
           "step_worst_err_over_tol": max(worst["err_h"] / worst["tol_h"],
                                          worst["err_delta"] / worst["tol_delta"]),
           "step_worst": worst, "steps": steps,
           "bf16_steps_checked": len(bf16_steps),
           "bf16_step_max_err_h": max(x["err_h"] for x in bf16_steps),
           "bf16_step_max_h_share": max(x["h_share"] for x in bf16_steps),
           "bf16_step_worst_delta_over_tol": max(x["err_delta"] / x["tol_delta"]
                                                 for x in bf16_steps),
           "bf16_steps": bf16_steps,
           "iters_checked": iters_checked, **growth[str(iters_checked)], "by_iters": growth,
           "atol_lowres": PARITY_ATOL_LOWRES, "atol_up": PARITY_ATOL_UP, "rtol": PARITY_RTOL}
    emit(res)
    if len(steps) != iters - 1 or len(bf16_steps) != iters - 1:
        raise AssertionError(f"{len(steps)} fp32 and {len(bf16_steps)} bf16 fused steps "
                             f"checked, expected {iters - 1} each")
    bad = ([f"fp32 {i}" for i, x in enumerate(steps) if not x["ok"]]
           + [f"bf16 {i}" for i, x in enumerate(bf16_steps) if not x["ok"]])
    if bad:
        raise AssertionError(f"fused_update disagrees with the plain step at steps {bad}")
    np.testing.assert_allclose(lf, lp, atol=PARITY_ATOL_LOWRES, rtol=PARITY_RTOL)
    np.testing.assert_allclose(uf, up, atol=PARITY_ATOL_UP, rtol=PARITY_RTOL)
    return [x["dnorm"] for x in steps]


def phase_early_exit(tmp: Path, dnorms, iters: int = 32):
    """The fp32 fused model with ``converge_eps`` half-way between two of
    phase 7's per-step signals: the first step whose signal is below every
    earlier one, and the smallest earlier one. It must stop after that
    step, launch K2 once a step and K1 once, and give the fixed loop's
    result for that many iterations."""
    import dataclasses

    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.ops import alt_corr, fused_update

    k = next((i for i in range(1, len(dnorms)) if dnorms[i] < min(dnorms[:i])), 1)
    eps = 0.5 * (min(dnorms[:k]) + dnorms[k])
    # the loop runs steps while the last signal is >= eps
    ran = next((i + 1 for i, d in enumerate(dnorms) if d < eps), len(dnorms))
    expected = ran + 1
    margin = min(abs(d - eps) for d in dnorms[:ran]) / eps
    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False,
                              fused_update=True)
    with _fp32_checks():
        early = load_model(dataclasses.replace(cfg, converge_eps=eps), device="cuda", seed=SEED)
        fixed = load_model(cfg, device="cuda", seed=SEED)
        a, b = _first_pair(tmp)
        alt_corr.LAUNCHES = fused_update.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        low_e, up_e, n = early(a, b, iters=iters)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {"alt_corr": alt_corr.LAUNCHES, "fused_update": fused_update.LAUNCHES}
        low_x, up_x = fixed(a, b, iters=n)
    err = float((up_e - up_x).abs().max())
    res = {"phase": "early_exit", "dtype": "float32", "converge_eps": eps, "iters": iters,
           "iters_executed": n, "expected": expected, "eps_relative_margin": margin,
           "launches": launches, "forward_ms": ms, "max_abs_diff_vs_fixed_loop": err,
           "dnorms": dnorms}
    emit(res)
    if n != expected:
        raise AssertionError(f"early exit ran {n} iterations, expected {expected}")
    if launches != {"alt_corr": 1, "fused_update": n - 1}:
        raise AssertionError(f"early exit launched {launches} for {n} iterations")
    if not (torch.isfinite(up_e).all() and err <= 1e-4):
        raise AssertionError(f"early exit result differs from the fixed loop by {err}")
    return res


def phase_parity_packed(tmp: Path, iters: int = 7, iters_checked: int = 2):
    """The raftstereo-realtime forward with the packed stage on one pair.

    (a) Each K3 call of the fp32 forward (TF32 off) and of the preset's
    bf16 forward is also run through the plain version on the same inputs
    and held to ``k3_errors``.
    (b) The fp32 forward with the stage is held to the forward without it
    after ``iters_checked`` iterations (PARITY_ATOL_*); random weights do
    not contract, so the difference is printed for 1, 2 and 7 iterations.
    """
    import dataclasses

    import numpy as np

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.experiments import packed_conv
    from raft_stereo_tpu_torch.models import extractor

    preset = PRESETS["raftstereo-realtime"]
    model = load_model(dataclasses.replace(preset, mixed_precision=False), device="cuda",
                       seed=SEED)
    a, b = _first_pair(tmp)
    kernel = packed_conv.packed_conv3x3
    calls = []

    def checked(xp, weight, scale=None, shift=None, relu_prologue=False):
        got = kernel(xp, weight, scale, shift, relu_prologue)
        want = packed_conv.packed_conv3x3_plain(xp, weight, scale, shift, relu_prologue)
        sums = k3_abs_sums(xp, weight, scale, shift, relu_prologue)
        calls.append({"dtype": str(xp.dtype).removeprefix("torch."),
                      "shape": list(xp.shape), **k3_errors(got, want, sums)})
        return got

    runs = {}
    saved = extractor._ENABLE_PACKED
    with _fp32_checks():
        try:
            extractor._ENABLE_PACKED = True
            packed_conv.packed_conv3x3 = checked
            model(a, b, iters=1)
            bf16_model = load_model(preset, device="cuda", seed=SEED)
            bf16_model(a, b, iters=1)  # K3 runs in the encoder, before the iterations
            del bf16_model
            packed_conv.packed_conv3x3 = kernel
            for n in (1, iters_checked, iters):
                if n in runs:
                    continue
                extractor._ENABLE_PACKED = True
                before = packed_conv.LAUNCHES
                low_k, up_k = model(a, b, iters=n)
                if packed_conv.LAUNCHES - before != K3_PER_TRUNK:
                    raise AssertionError(f"packed forward launched packed_conv "
                                         f"{packed_conv.LAUNCHES - before} times, "
                                         f"expected {K3_PER_TRUNK}")
                extractor._ENABLE_PACKED = False
                low_p, up_p = model(a, b, iters=n)
                runs[n] = [t.cpu().numpy() for t in (low_k, low_p, up_k, up_p)]
        finally:
            packed_conv.packed_conv3x3 = kernel
            extractor._ENABLE_PACKED = saved
    growth = {}
    for n, (lk, lp, uk, up) in runs.items():
        if not (np.isfinite(uk).all() and np.isfinite(up).all()):
            raise AssertionError(f"non-finite disparity in the packed parity forwards at {n} iterations")
        growth[str(n)] = {"max_abs_err_lowres": float(np.abs(lk - lp).max()),
                          "max_abs_err_up": float(np.abs(uk - up).max()),
                          "max_abs_disp": float(np.abs(up).max())}
    lk, lp, uk, up = runs[iters_checked]
    fp32 = [c for c in calls if c["dtype"] == "float32"]
    bf16 = [c for c in calls if c["dtype"] == "bfloat16"]
    res = {"phase": "parity_realtime_packed", "cudnn_allow_tf32": False,
           "matmul_allow_tf32": False, "shape": list(uk.shape),
           "k3_calls_checked": {"float32": len(fp32), "bfloat16": len(bf16)},
           "k3_fp32_max_abs_err": max(c["max_abs_err"] for c in fp32),
           "k3_fp32_worst_err_over_tol": max(c["max_abs_err"] / c["tol"] for c in fp32),
           "k3_bf16_max_ulps": max(c["max_ulps"] for c in bf16),
           "k3_bf16_max_share": max(c["share"] for c in bf16),
           "k3_bf16_max_order_ratio": max(c["order_ratio"] for c in bf16),
           "k3_calls": calls, "iters_checked": iters_checked, **growth[str(iters_checked)],
           "by_iters": growth, "atol_lowres": PARITY_ATOL_LOWRES, "atol_up": PARITY_ATOL_UP,
           "rtol": PARITY_RTOL}
    emit(res)
    if len(fp32) != K3_PER_TRUNK or len(bf16) != K3_PER_TRUNK:
        raise AssertionError(f"{len(fp32)} fp32 and {len(bf16)} bf16 K3 calls checked, "
                             f"expected {K3_PER_TRUNK} each")
    bad = [f"{c['dtype']} {i}" for i, c in enumerate(calls) if not c["ok"]]
    if bad:
        raise AssertionError(f"packed_conv disagrees with its plain version at calls {bad}")
    np.testing.assert_allclose(lk, lp, atol=PARITY_ATOL_LOWRES, rtol=PARITY_RTOL)
    np.testing.assert_allclose(uk, up, atol=PARITY_ATOL_UP, rtol=PARITY_RTOL)
    return res


# ------------------------------------------------------------------ training

# The published SceneFlow recipe (README: --batch_size 8 --train_iters 22
# --mixed_precision; the upstream RAFT-Stereo README's augmentation flags)
# on the raftstereo architecture at its 320x720 crops.
TRAIN_RECIPE = ["--batch_size", "8", "--train_iters", "22", "--mixed_precision",
                "--image_size", "320", "720", "--spatial_scale", "-0.2", "0.4",
                "--saturation_range", "0", "1.4", "--validation_frequency", "100000"]
TRAIN_ITERS = 22
TRAIN_PAIRS = 16  # synthetic FlyingThings3D TRAIN pairs at 540x960
# K1's backward is the plain version's autograd, one level at a time, against
# the plain version's autograd over all levels at once: the same products,
# with df1 summed over the levels in another order.
K1_GRAD_RTOL = 1e-6
# K3's backward is the plain version's autograd on the same saved inputs in
# both paths; cuDNN's weight-gradient algorithms may sum in another order
# (atomics). fp32: 1e-5 of the gradient's largest magnitude; bf16: the
# fp32 sums cast to bf16, so one bf16 ulp at the largest magnitude (2^-7 of
# it).
K3_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# One fp32 train step (TF32 off, cuDNN deterministic) with K1 against the
# same step with the plain lookup: the forwards differ by K1's fp32 sum order
# (ALT_TOL on each correlation), which two refinement iterations and random
# weights carry into every gradient; each parameter's gradient is held to
# TRAIN_STEP_GRAD_RTOL of its largest magnitude (the printed errors say how
# far inside it they are), the loss to 1e-5 relative. The planted fault (the
# backward recomputing every level at the full-resolution coordinates, the
# level scale dropped) must fail it.
TRAIN_STEP_GRAD_RTOL = 1e-2
TRAIN_STEP_LOSS_RTOL = 1e-5
# A conv bias that feeds an affine-free instance norm has a zero gradient;
# each run's value is fp32 rounding noise of a sum over the layer's P
# positions, about eps32·sqrt(P) of the weight gradient's scale (1.4e-5 at
# the stem's P = 160 x 360): held below 1e-4 of that scale in both runs.
ZERO_GRAD_NOISE_RTOL = 1e-4


def _alt_vjp_dropped_level_scale(fmap1, fmap2_pyramid, coords_x, radius, grad):
    """A planted fault: K1's backward with coordinates not divided by 2^level."""
    import torch

    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    K = 2 * radius + 1
    df1, dlevels = None, []
    for lvl, f2 in enumerate(fmap2_pyramid):
        with torch.enable_grad():
            a = fmap1.detach().requires_grad_(True)
            b = f2.detach().requires_grad_(True)
            out = corr_lookup_alt_plain(a, [b], coords_x.detach(), radius)
            da, db = torch.autograd.grad(out, (a, b), grad[..., lvl * K:(lvl + 1) * K])
        df1 = da if df1 is None else df1 + da
        dlevels.append(db)
    return df1, dlevels, torch.zeros_like(coords_x)


def _k3_vjp_dropped_prologue(xp, weight, scale, shift, relu_prologue, grad):
    """A planted fault: K3's backward taken as if the conv had no prologue,
    with zero gradients for scale and shift."""
    import torch

    from raft_stereo_tpu_torch.experiments.packed_conv import packed_conv3x3_plain

    with torch.enable_grad():
        x = xp.detach().requires_grad_(True)
        w = weight.detach().requires_grad_(True)
        dx, dw = torch.autograd.grad(packed_conv3x3_plain(x, w), (x, w), grad)
    return dx, dw, torch.zeros_like(scale), torch.zeros_like(shift)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _alt_bwd_bound(f1, pyr, coords, radius):
    """Least time of K1's backward on the card: every input (f1, the
    levels, the coordinates, the output gradient) read once and the
    gradients of f1 and the levels written once, against its products (the
    recomputed window sums and the two gradient products, 3x the forward's
    2·D a valid row)."""
    fwd = _alt_bound(f1, pyr, coords, radius)
    B, H, W1, D = f1.shape
    out = B * H * W1 * len(pyr) * (2 * radius + 1)
    n_bytes = 4 * (2 * f1.numel() + 2 * sum(p.numel() for p in pyr) + coords.numel() + out)
    flops = 3 * fwd["flops"]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_train_grad_check():
    """K1 and K3 through their autograd Functions (kernel forward, plain
    backward) against the plain versions' autograd, at the training
    shapes: K1 at [8, 80, 180, 256] (batch 8 at 320x720, 1/4 resolution),
    L=4, r=4; K3 at the realtime training stem, batch 8's 16 images through
    the shared backbone at 320x720, layer1 at [16, 160, 360, 64], fp32 and
    bf16, without a prologue (as the stem calls it) and with the relu
    prologue (scale [16, 128], shift [16, 64]; their gradients too). A
    dropped level scale planted in K1's backward and a dropped prologue
    planted in K3's must each fail."""
    import torch

    from raft_stereo_tpu_torch.experiments import packed_conv, packed_encoder
    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    res = {"phase": "train_grad_check"}
    with _fp32_checks():
        B, H, W1, D, L, r = 8, 80, 180, 256, 4, 4
        f1, pyr, coords = _alt_inputs(B, H, W1, D, L, seed=SEED + 40)
        pyr = [p.contiguous() for p in pyr]
        g = torch.randn((B, H, W1, L * (2 * r + 1)), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 41))

        def grads(fn):
            a = f1.clone().requires_grad_(True)
            lv = [p.clone().requires_grad_(True) for p in pyr]
            out = fn(a, lv, coords, r)
            out.backward(g)
            torch.cuda.synchronize()
            return out.detach(), a.grad, [p.grad for p in lv]

        out_k, df1_k, dl_k = grads(alt_corr.corr_lookup_alt)
        out_p, df1_p, dl_p = grads(corr_lookup_alt_plain)
        k1 = {"shape": [B, H, W1, D], "levels": L, "radius": r,
              "fwd_max_abs_err": float((out_k - out_p).abs().max()), "fwd_tol": ALT_TOL,
              "df1_rel_err": _rel(df1_k, df1_p),
              "dlevel_rel_err": [_rel(a, b) for a, b in zip(dl_k, dl_p)],
              "grad_rtol": K1_GRAD_RTOL}
        ok = (k1["fwd_max_abs_err"] <= ALT_TOL and k1["df1_rel_err"] <= K1_GRAD_RTOL
              and max(k1["dlevel_rel_err"]) <= K1_GRAD_RTOL)
        real = alt_corr.alt_lookup_vjp
        alt_corr.alt_lookup_vjp = _alt_vjp_dropped_level_scale
        try:
            _, df1_f, dl_f = grads(alt_corr.corr_lookup_alt)
        finally:
            alt_corr.alt_lookup_vjp = real
        k1["fault_dropped_level_scale_rel_err"] = max(_rel(a, b) for a, b in zip(dl_f, dl_p))
        fault_caught = k1["fault_dropped_level_scale_rel_err"] > K1_GRAD_RTOL
        k1["bwd_ms"] = _time_ms(lambda: alt_corr.alt_lookup_vjp(f1, pyr, coords, r, g), 5,
                                warmup=1)
        k1["fwd_ms"] = _time_ms(lambda: alt_corr.corr_lookup_alt(f1, pyr, coords, r), 20)
        bwd = _alt_bwd_bound(f1, pyr, coords, r)
        fwd = _alt_bound(f1, pyr, coords, r)
        k1.update(fwd_bound_ms=fwd["bound_ms"], fwd_bound_by=fwd["bound_by"],
                  bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
                  bwd_bytes=bwd["bytes"], bwd_flops=bwd["flops"])
        res["k1"] = k1
        del f1, pyr, coords, g, out_k, out_p, df1_k, df1_p, dl_k, dl_p, df1_f, dl_f
        torch.cuda.empty_cache()

        # the realtime stem: the stacked batch of 16 at 320x720, stride 2
        stem_in = torch.empty((16, 3, 320, 720), device="meta")
        if not packed_encoder.packable(stem_in, "batch", 2):
            raise AssertionError("the packed stage refuses the realtime training stem")
        k3 = []
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            xp, w, _, _, _ = k3_inputs(16, 160, 360, dtype, seed=SEED + 42)
            g3 = torch.randn(xp.shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(SEED + 43)).to(dtype)

            def run(fn):
                x = xp.clone().requires_grad_(True)
                ww = w.clone().requires_grad_(True)
                out = fn(x, ww)
                out.backward(g3)
                torch.cuda.synchronize()
                return out.detach(), x.grad, ww.grad

            out_k, dx_k, dw_k = run(packed_conv.packed_conv3x3)
            out_p, dx_p, dw_p = run(packed_conv.packed_conv3x3_plain)
            fwd = k3_errors(out_k, out_p, k3_abs_sums(xp, w))
            c = {"dtype": dname, "shape": [16, 160, 360, 64], "fwd": fwd,
                 "dx_rel_err": _rel(dx_k, dx_p), "dw_rel_err": _rel(dw_k, dw_p),
                 "grad_rtol": K3_GRAD_RTOL[dname],
                 "bwd_plain_ms": _time_ms(lambda: packed_conv.packed_conv_vjp(
                     xp, w, None, None, False, g3), 5, warmup=1),
                 "fwd_ms": _time_ms(lambda: packed_conv.packed_conv3x3(xp, w), 20)}
            c["ok"] = (fwd["ok"] and c["dx_rel_err"] <= c["grad_rtol"]
                       and c["dw_rel_err"] <= c["grad_rtol"])
            k3.append(c)
            del xp, w, g3, out_k, out_p, dx_k, dx_p, dw_k, dw_p
            torch.cuda.empty_cache()
        res["k3"] = k3

        # the relu prologue, with the scale and shift gradients
        k3p = []
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            xp, w, sc, sh, relu = k3_inputs(16, 160, 360, dtype, "relu", seed=SEED + 44)
            sh = sh[:, :64].contiguous()  # the [B, 64] form, both halves' gradients summed
            g3 = torch.randn(xp.shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(SEED + 45)).to(dtype)

            def run(fn):
                ins = [t.clone().requires_grad_(True) for t in (xp, w, sc, sh)]
                out = fn(*ins, relu_prologue=relu)
                out.backward(g3)
                torch.cuda.synchronize()
                return out.detach(), [t.grad for t in ins]

            out_k, d_k = run(packed_conv.packed_conv3x3)
            out_p, d_p = run(packed_conv.packed_conv3x3_plain)
            fwd = k3_errors(out_k, out_p, k3_abs_sums(xp, w, sc, sh, relu))
            errs = {f"d{n}_rel_err": _rel(a, b)
                    for n, a, b in zip(("x", "w", "scale", "shift"), d_k, d_p)}
            c = {"dtype": dname, "shape": [16, 160, 360, 64], "prologue": "relu",
                 "scale_shape": list(sc.shape), "shift_shape": list(sh.shape), "fwd": fwd,
                 **errs, "grad_rtol": K3_GRAD_RTOL[dname]}
            c["ok"] = fwd["ok"] and max(errs.values()) <= c["grad_rtol"]
            if dname == "float32":
                real = packed_conv.packed_conv_vjp
                packed_conv.packed_conv_vjp = _k3_vjp_dropped_prologue
                try:
                    _, d_f = run(packed_conv.packed_conv3x3)
                finally:
                    packed_conv.packed_conv_vjp = real
                c["fault_dropped_prologue_rel_err"] = max(
                    _rel(a, b) for a, b in zip(d_f, d_p))
                k3_fault_caught = c["fault_dropped_prologue_rel_err"] > c["grad_rtol"]
                del d_f
            k3p.append(c)
            del xp, w, sc, sh, g3, out_k, out_p, d_k, d_p
            torch.cuda.empty_cache()
        res["k3_prologue"] = k3p
        res["k2"], k2_launches = _k2_grad_check()
    emit(res)
    if not ok:
        raise AssertionError(f"K1's autograd disagrees with the plain version's: {k1}")
    if not fault_caught:
        raise AssertionError("the K1 gradient check passes a dropped level scale")
    bad = [f"{c['dtype']} {c.get('prologue')}" for c in k3 + k3p if not c["ok"]]
    if bad:
        raise AssertionError(f"K3's autograd disagrees with the plain version's in {bad}")
    if not k3_fault_caught:
        raise AssertionError("the K3 gradient check passes a dropped prologue")
    bad = [c["dtype"] for c in res["k2"] if not (c.get("bitwise_equal")
                                                  and c.get("flow_grad_is_none"))]
    if bad:
        raise AssertionError(f"K2's gradients with the kernel forward differ from the plain "
                             f"autograd's in {bad}: {res['k2']}")
    return res, {"phase": "train_grad_check_k2", "launches": k2_launches}


def _synthetic_batch(B, H, W, seed):
    """A seeded training batch on the card: textured pairs shifted by a
    disparity field, as the loader gives them (NHWC, [0, 255])."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pad = 64
    tex = torch.rand((B, 3, H, W + 2 * pad), generator=g, device="cuda")
    tex = torch.nn.functional.avg_pool2d(tex, 5, stride=1, padding=2) * 255.0
    d = 8 + 4 * torch.arange(B, device="cuda")
    left = tex[:, :, :, pad:pad + W]
    right = torch.stack([tex[b, :, :, pad + int(d[b]):pad + int(d[b]) + W] for b in range(B)])
    flow = d.float().view(B, 1, 1, 1).expand(B, H, W, 1).contiguous()
    return {"img1": left.permute(0, 2, 3, 1).contiguous(),
            "img2": right.permute(0, 2, 3, 1).contiguous(),
            "flow": flow, "valid": torch.ones((B, H, W), device="cuda")}


def _biases_before_instance_norm(model):
    """{bias name: its conv's weight name} for each conv whose output goes
    straight into an affine-free instance norm: the norm removes the bias,
    so its exact gradient is zero and what either run computes is rounding
    noise."""
    from raft_stereo_tpu_torch.models.layers import InstanceNorm, ResidualBlock

    out = {}
    for name, m in model.named_modules():
        pairs = []
        if isinstance(m, ResidualBlock):
            pairs = [("conv1", m.norm1), ("conv2", m.norm2)]
            if m.downsample is not None:
                pairs.append(("downsample.0", m.norm3))
        elif hasattr(m, "conv1") and hasattr(m, "norm1") and hasattr(m, "layer1"):
            pairs = [("conv1", m.norm1)]  # an encoder's stem
        for conv, norm in pairs:
            if isinstance(norm, InstanceNorm):
                out[f"{name}.{conv}.bias"] = f"{name}.{conv}.weight"
    return out


def _step_grads(model, batch, iters):
    import torch

    from raft_stereo_tpu_torch.losses import sequence_loss

    model.zero_grad(set_to_none=True)
    preds = model(batch["img1"], batch["img2"], iters=iters, test_mode=False, remat=True)
    loss, _ = sequence_loss(preds, batch["flow"], batch["valid"])
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def phase_train_step_check():
    """One fp32 train step (TF32 off, cuDNN deterministic; raftstereo with
    the ``alt`` lookup, 2 iterations, batch 2, 320x720) with every lookup
    through K1 and its backward, against the same step with the lookups
    through ``corr_lookup_alt_plain``: loss and every parameter's gradient.
    A dropped level scale planted in K1's backward must fail it."""
    import dataclasses

    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

    cfg = dataclasses.replace(PRESETS["raftstereo"], corr_implementation="alt")
    batch = _synthetic_batch(2, 320, 720, SEED + 50)
    saved_det = torch.backends.cudnn.deterministic
    with _fp32_checks():
        torch.backends.cudnn.deterministic = True
        try:
            model = load_model(cfg, seed=SEED).train()
            alt_corr.LAUNCHES = 0
            loss_k, grads_k = _step_grads(model, batch, 2)
            launches = alt_corr.LAUNCHES
            real_lookup, real_vjp = alt_corr.corr_lookup_alt, alt_corr.alt_lookup_vjp
            alt_corr.corr_lookup_alt = corr_lookup_alt_plain
            try:
                loss_p, grads_p = _step_grads(model, batch, 2)
            finally:
                alt_corr.corr_lookup_alt = real_lookup
            alt_corr.alt_lookup_vjp = _alt_vjp_dropped_level_scale
            try:
                loss_f, grads_f = _step_grads(model, batch, 2)
            finally:
                alt_corr.alt_lookup_vjp = real_vjp
        finally:
            torch.backends.cudnn.deterministic = saved_det
    # a bias before an instance norm: both runs' gradient is rounding noise,
    # held to ZERO_GRAD_NOISE_RTOL of its conv's weight gradient instead
    zero = _biases_before_instance_norm(model)
    noise = {n: max(float(grads_k[n].abs().max()), float(grads_p[n].abs().max()))
             / float(grads_p[w].abs().max()) for n, w in zero.items()}
    errs = {n: _rel(grads_k[n], g) for n, g in grads_p.items() if n not in zero}
    fault = {n: _rel(grads_f[n], g) for n, g in grads_p.items() if n not in zero}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    res = {"phase": "train_step_check", "config": "raftstereo, corr alt, fp32, TF32 off",
           "batch": 2, "input": [320, 720], "iters": 2, "k1_launches": launches,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "params": len(errs), "grad_rel_err_max": max(errs.values()),
           "zero_gradient_biases": len(zero), "zero_gradient_noise_max": max(noise.values()),
           "zero_gradient_noise_rtol": ZERO_GRAD_NOISE_RTOL,
           "grad_rel_err_median": sorted(errs.values())[len(errs) // 2],
           "worst": worst, "grad_rtol": TRAIN_STEP_GRAD_RTOL,
           "loss_rtol": TRAIN_STEP_LOSS_RTOL,
           "fault_dropped_level_scale": {"grad_rel_err_max": max(fault.values()),
                                         "loss": loss_f,
                                         "params_over_tol": sum(
                                             v > TRAIN_STEP_GRAD_RTOL for v in fault.values())}}
    emit(res)
    del model, grads_k, grads_p, grads_f
    torch.cuda.empty_cache()
    if launches != 2 * 2:  # two lookups, each recomputed once by remat
        raise AssertionError(f"K1 launched {launches} times in the step, expected 4")
    if not (res["loss_rel_err"] <= TRAIN_STEP_LOSS_RTOL
            and res["grad_rel_err_max"] <= TRAIN_STEP_GRAD_RTOL
            and res["zero_gradient_noise_max"] <= ZERO_GRAD_NOISE_RTOL):
        raise AssertionError(f"the K1 train step disagrees with the plain one: {worst}")
    if res["fault_dropped_level_scale"]["grad_rel_err_max"] <= TRAIN_STEP_GRAD_RTOL:
        raise AssertionError("the train step check passes a dropped level scale")
    return res


def _write_things_tree(root: Path, n: int = TRAIN_PAIRS, H: int = 540, W: int = 960,
                       seed: int = SEED, split: str = "TRAIN", pair1_shape=None) -> None:
    """A synthetic FlyingThings3D ``split`` tree (the reference layout):
    ``n`` textured pairs, the right image the left shifted by a per-pair
    disparity, as PNGs, with that disparity as PFM; pair 1 at
    ``pair1_shape`` (H, W) when given."""
    import numpy as np
    from PIL import Image

    from raft_stereo_tpu_torch.data.frame_io import write_pfm

    rng = np.random.RandomState(seed)
    pad = 64
    base = root / "datasets" / "FlyingThings3D"
    for k in range(n):
        scene = f"{k // 8:04d}"
        h, w = pair1_shape if k == 1 and pair1_shape else (H, W)
        tex = rng.rand(h, w + 2 * pad, 3)
        for axis in (0, 1):
            tex = sum(np.roll(tex, s, axis=axis) for s in range(-2, 3)) / 5.0
        tex = (tex * 255).astype(np.uint8)
        d = 6 + 5 * (k % 8)
        for side, off in (("left", 0), ("right", d)):
            path = base / "frames_finalpass" / split / "A" / scene / side / f"{k:04d}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.ascontiguousarray(tex[:, pad + off:pad + off + w])).save(path)
        dp = base / "disparity" / split / "A" / scene / "left" / f"{k:04d}.pfm"
        dp.parent.mkdir(parents=True, exist_ok=True)
        write_pfm(str(dp), np.full((h, w), float(d), np.float32))


@contextlib.contextmanager
def _chdir(path: Path):
    import os

    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _profile_alt_step(state, argv):
    """One more step of the alt run under torch.profiler: K1's forward
    device ms (its kernel's device time), the plain recompute-backward's ms
    (CUDA events around each ``alt_lookup_vjp``) and the step's wall and
    device ms. Its launches do not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch import train
    from raft_stereo_tpu_torch.data.datasets import fetch_dataloader
    from raft_stereo_tpu_torch.ops import alt_corr
    from raft_stereo_tpu_torch.parallel.train_step import make_train_step

    args = train.build_parser(argv).parse_args(argv)
    loader = fetch_dataloader(args)
    stream = loader.stream(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(stream).items()}
    stream.close()
    step = make_train_step(TRAIN_ITERS, remat=True, nonfinite_guard=True)
    spans = []
    real = alt_corr.alt_lookup_vjp

    def timed(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a)
        end.record()
        spans.append((start, end))
        return out

    with _launches_kept():
        step(state, batch)
        torch.cuda.synchronize()
        alt_corr.alt_lookup_vjp = timed
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            alt_corr.alt_lookup_vjp = real
    k1_us = device_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        us = getattr(e, "cuda_time_total", 0.0) if us is None else us
        device_us += us
        if "alt_corr_kernel" in e.key:
            k1_us += us
    recompute = [s.elapsed_time(e) for s, e in spans]
    return {"k1_forward_ms": k1_us / 1e3, "recompute_backward_ms": sum(recompute),
            "recompute_calls": len(recompute),
            "recompute_backward_ms_per_call": sum(recompute) / max(len(recompute), 1),
            "step_wall_ms_profiled": wall * 1e3, "step_device_ms": device_us / 1e3,
            "recompute_share_of_step_wall": sum(recompute) / (wall * 1e3)}


def phase_train_path(tmp: Path, corr: str = "reg", steps: int = 6):
    """``raft_stereo_tpu_torch.train.main`` on the synthetic FlyingThings3D
    TRAIN tree with the recipe above (raftstereo, bf16, batch 8, 320x720,
    22 iterations, remat), ``steps`` steps, with the ``corr`` lookup. The
    kernel counts are set to 0 just before and read just after; with
    ``alt`` K1 must launch steps x 22 x 2 times (remat runs each
    iteration's forward again in the backward), and one more step is
    profiled."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import train
    from raft_stereo_tpu_torch.runtime.checkpoint import read_manifest, verify_checkpoint
    from raft_stereo_tpu_torch.utils import metrics

    name = "train_path" + ("_alt" if corr == "alt" else "")
    root = tmp / "train"
    if not (root / "datasets").exists():
        _write_things_tree(root)
    argv = ["--name", name, "--train_datasets", "sceneflow", "--num_steps", str(steps),
            "--corr_implementation", corr, *TRAIN_RECIPE]
    saved_freq = metrics.SUM_FREQ
    metrics.SUM_FREQ = 1  # a metrics row every step: the loss per step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _chdir(root):
            _zero_launches()
            t0 = time.perf_counter()
            result = train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            rows = [json.loads(ln) for ln in (Path("runs") / name / "metrics.jsonl")
                    .read_text().splitlines()]
            final = str(Path(result.path).resolve())
            manifest = read_manifest(final)
            verified = verify_checkpoint(final)
            prof = _profile_alt_step(result.state, argv) if corr == "alt" else None
    finally:
        metrics.SUM_FREQ = saved_freq
    losses = [r["live_loss"] for r in rows if "step" in r and "live_loss" in r]
    step_s = result.timings.step_seconds
    wall_s = [a + b for a, b in zip(step_s, result.timings.wait_seconds)]
    first = 2 if len(step_s) >= 6 else 1  # steps 3-6, or all but the first
    median = statistics.median(step_s[first:6])
    res = {
        "phase": name, "entry": "raft_stereo_tpu_torch.train.main", "argv": argv,
        "config": "raftstereo (hidden 128x3, 3 GRU levels, fnet 256, 4 levels r4, "
                  "n_downsample 2, batch norm), bf16 compute on fp32 parameters, remat",
        "dataset": f"synthetic FlyingThings3D TRAIN, {TRAIN_PAIRS} pairs at 540x960",
        "steps": result.total_steps, "launches": launches,
        "s_per_step_median_steps_3_6": median, "step_seconds": step_s,
        "pairs_per_s": 8 / median,
        "pairs_per_s_with_data_wait": 8 * len(wall_s[first:6]) / sum(wall_s[first:6]),
        "data_wait_seconds": result.timings.wait_seconds,
        "loop_means": result.timings.means(),
        "wall_s_with_setup": wall, "max_memory_allocated_bytes": peak,
        "loss_per_step": losses, "final_checkpoint": final, "final_verified": verified,
        "final_step": (manifest or {}).get("step"),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    if prof is not None:
        res["profiled_step"] = prof
    emit(res)
    del result
    torch.cuda.empty_cache()
    if res["steps"] != steps or res["final_step"] != steps or not verified:
        raise AssertionError(f"{name}: {res['steps']} steps, final checkpoint step "
                             f"{res['final_step']}, verified {verified}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses per step {losses}")
    want_k1 = steps * TRAIN_ITERS * 2 if corr == "alt" else 0
    if launches["alt_corr"] != want_k1:
        raise AssertionError(f"{name}: K1 launched {launches['alt_corr']} times, "
                             f"expected {want_k1}")
    return res


def phase_train_resume(tmp: Path):
    """A run cut by SIGTERM at step 2 (``RAFT_FI_SIGTERM_STEP``) leaves an
    emergency checkpoint; ``--resume auto`` restores it (held bitwise to
    the state the cut run ended with: parameters, Adam moments, step and
    lr) and continues to step 4. At a reduced depth: batch 2, 4
    iterations. The continued trajectory is not held bitwise on the card
    (cuDNN's backward may sum with atomics)."""
    import dataclasses
    import os

    import torch

    from raft_stereo_tpu_torch import train
    from raft_stereo_tpu_torch.config import PRESETS, TrainConfig
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.parallel.train_step import create_train_state
    from raft_stereo_tpu_torch.runtime import faultinject
    from raft_stereo_tpu_torch.runtime.checkpoint import read_manifest, verify_checkpoint
    from raft_stereo_tpu_torch.runtime.loop import resume_state
    from raft_stereo_tpu_torch.utils.checkpoints import keyed_leaves

    root = tmp / "train"
    if not (root / "datasets").exists():
        _write_things_tree(root)
    argv = ["--name", "resume", "--train_datasets", "sceneflow", "--num_steps", "4",
            "--batch_size", "2", "--train_iters", "4", "--mixed_precision",
            "--image_size", "320", "720", "--spatial_scale", "-0.2", "0.4",
            "--saturation_range", "0", "1.4"]
    with _chdir(root), _launches_kept():
        os.environ["RAFT_FI_SIGTERM_STEP"] = "2"
        try:
            cut = train.main(argv)
        finally:
            del os.environ["RAFT_FI_SIGTERM_STEP"]
            faultinject.reset()
        emergency = read_manifest(str(cut.path))
        saved = keyed_leaves(cut.state.state_dict())
        cfg = dataclasses.replace(PRESETS["raftstereo"], mixed_precision=True)
        fresh = create_train_state(load_model(cfg, seed=7).train(),
                                   TrainConfig(lr=2e-4, num_steps=4))
        restored, manifest, path = resume_state("auto", Path("checkpoints") / "resume", fresh)
        got = keyed_leaves(restored.state_dict())
        mism = [k for k, v in saved.items()
                if not (torch.equal(v.cpu(), got[k].cpu()) if isinstance(v, torch.Tensor)
                        else v == got.get(k))]
        lr_equal = restored.lr == cut.state.lr and restored.step == cut.state.step
        del fresh, restored, got, saved
        done = train.main(argv + ["--resume", "auto"])
        final = str(Path(done.path).resolve())
        res = {"phase": "train_resume", "argv": argv, "cut_at": cut.total_steps,
               "emergency": {"tag": (emergency or {}).get("tag"),
                             "step": (emergency or {}).get("step")},
               "resumed_from": path, "restored_leaves": len(keyed_leaves(
                   done.state.state_dict())), "restored_mismatches": mism[:5],
               "restored_step_and_lr_equal": lr_equal, "continued_to": done.total_steps,
               "final_verified": verify_checkpoint(final),
               "final_stream_pos": (read_manifest(final) or {}).get("stream_pos"),
               "trajectory_held_bitwise": False}
    emit(res)
    del cut, done
    torch.cuda.empty_cache()
    if res["cut_at"] != 2 or res["emergency"] != {"tag": "emergency", "step": 2}:
        raise AssertionError(f"train_resume: the cut run {res}")
    if mism or not lr_equal:
        raise AssertionError(f"train_resume: restored state differs in {mism[:5]}, "
                             f"step/lr equal {lr_equal}")
    if not (res["continued_to"] == 4 and res["final_verified"] and res["final_stream_pos"] == 4):
        raise AssertionError(f"train_resume: the resumed run {res}")
    return res

# ------------------------------------------ training across processes (DDP)

# ddp_path: ``train --multihost`` under torchrun, one process (NCCL, world
# 1), with the train_path_alt recipe for DDP_STEPS steps; then the parity
# check of two gloo ranks sharing the card against one process.
DDP_STEPS = 4
DDP_TIMEOUT_S = 600.0
# The parity check: raftstereo with the alt lookup, fp32 (TF32 off, cuDNN
# deterministic), 2 iterations, global batch 8 at 320x720 (4 a rank), two
# steps; rank 0's samples valid on a quarter of their pixels, rank 1's on
# all. The ranks and the one process compute the same sums in other orders
# (convs at batch 4 and 8, the gradient all-reduce): Adam's first moment
# (0.1 x the clipped gradient, then the second step's share) is held per
# tensor to TRAIN_STEP_GRAD_RTOL of its largest magnitude, as the train
# step check holds its gradients, and the conv biases before an instance
# norm (rounding noise both ways) to ZERO_GRAD_NOISE_RTOL of their conv
# weight's. Each updated parameter element is held to what that moment
# tolerance allows Adam's update, lr x min(2, 2 tol/|mu|) summed over the
# steps, plus 1e-6 of |p| (the fp32 rounding of the update's arithmetic).
# The losses and EPEs: 1e-5 relative at the first step, 1e-4 at the second
# (whose parameters already differ where Adam's sign flipped); the 1/3/5 px
# fractions 1e-4 absolute (pixels within rounding of a threshold). The
# ranks' states: bitwise equal to each other. A planted per-rank mean (DDP
# averaging the ranks' own masked means) must fail.
DDP_PARITY = {"batch": 8, "hw": (320, 720), "iters": 2, "steps": 2, "valid_rank0": 0.25}
DDP_LOSS_RTOL = (1e-5, 1e-4)
DDP_PX_ATOL = 1e-4


def _ddp_batch(seed):
    """The parity check's global batch on the card: rank 0's half valid on
    a quarter of its pixels."""
    import torch

    B, (H, W) = DDP_PARITY["batch"], DDP_PARITY["hw"]
    batch = _synthetic_batch(B, H, W, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    quarter = (torch.rand((B // 2, H, W), generator=g, device="cuda")
               < DDP_PARITY["valid_rank0"]).float()
    batch["valid"] = torch.cat([quarter, batch["valid"][B // 2:]])
    return batch


def _ddp_parity_run(ddp: bool, plant_per_rank_mean: bool = False):
    """The parity check's steps from seeded weights: [(metrics, state)]
    after each step, the states' tensors on the host. ``ddp``: this
    process is a rank of the group and steps on its piece."""
    import dataclasses

    import torch

    from raft_stereo_tpu_torch import losses
    from raft_stereo_tpu_torch.config import PRESETS, TrainConfig
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.parallel import mesh
    from raft_stereo_tpu_torch.parallel.train_step import create_train_state, make_train_step

    cfg = dataclasses.replace(PRESETS["raftstereo"], corr_implementation="alt")
    real = losses.sequence_loss
    if plant_per_rank_mean:
        losses.sequence_loss = lambda *a, distributed=False, **k: real(*a, **k)
    saved_det = torch.backends.cudnn.deterministic
    out = []
    try:
        with _fp32_checks():
            torch.backends.cudnn.deterministic = True
            state = create_train_state(load_model(cfg, seed=SEED).train(),
                                       TrainConfig(lr=2e-4, num_steps=100))
            step = make_train_step(DDP_PARITY["iters"], nonfinite_guard=True, ddp=ddp)
            for k in range(1 if plant_per_rank_mean else DDP_PARITY["steps"]):
                batch = _ddp_batch(SEED + 70 + k)
                state, metrics = step(state, mesh.shard_batch(batch) if ddp else batch)
                torch.cuda.synchronize()
                out.append(({n: float(v) for n, v in metrics.items()},
                            _ddp_state_tensors(state)))
    finally:
        torch.backends.cudnn.deterministic = saved_det
        losses.sequence_loss = real
    return out


def _ddp_state_tensors(state) -> dict:
    """{parameter name: (parameter, exp_avg)} on the host."""
    opt = state.optimizer
    return {n: (p.detach().to("cpu", copy=True), opt.state[p]["exp_avg"].to("cpu", copy=True))
            for n, p in state.model.named_parameters()}


def _ddp_digest(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for n in sorted(tensors):
        for t in tensors[n]:
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def ddp_rank_main(rank: int, workdir: str) -> int:
    """One of the parity check's two gloo ranks, sharing ``cuda:0``
    (``python3 chip_smoke.py ddp-rank RANK DIR``; the parent sets RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT): its metrics and a digest of
    its state after each step into ``DIR/rank<RANK>.json``, rank 0's states
    into ``DIR/rank0_<k>.pt``, the planted per-rank mean's too."""
    import torch

    from raft_stereo_tpu_torch.parallel import mesh

    mesh.init_distributed("cuda:0", backend="gloo")
    try:
        runs = {"ddp": _ddp_parity_run(True), "planted": _ddp_parity_run(True, True)}
    finally:
        mesh.destroy()
    report = {}
    for name, steps in runs.items():
        report[name] = [{"metrics": m, "digest": _ddp_digest(t)} for m, t in steps]
        if rank == 0:
            for k, (_, t) in enumerate(steps):
                torch.save(t, Path(workdir) / f"rank0_{name}_{k}.pt")
    report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(report))
    return 0


def _ddp_mismatches(got: dict, want: dict, lrs, zero: dict) -> dict:
    """The parameters outside the parity rules (see DDP_PARITY), with each
    one's moment and parameter error over its allowance."""
    bad, worst = {}, {"moment": 0.0, "param": 0.0}
    for n, (p, m) in got.items():
        wp, wm = want[n][0].double(), want[n][1].double()
        p, m = p.double(), m.double()
        if n in zero:
            tol = ZERO_GRAD_NOISE_RTOL * float(want[zero[n]][1].abs().max()) + 1e-12
        else:
            tol = TRAIN_STEP_GRAD_RTOL * float(wm.abs().max()) + 1e-12
        allow = (sum(lrs) * (2.0 * tol / wm.abs().clamp(min=1e-30)).clamp(max=2.0)
                 + 1e-6 * wp.abs() + 1e-9)
        m_err = float((m - wm).abs().max()) / tol
        p_err = float(((p - wp).abs() / allow).max())
        worst = {"moment": max(worst["moment"], m_err), "param": max(worst["param"], p_err)}
        if m_err > 1 or p_err > 1:
            bad[n] = (m_err, p_err)
    return {"over": bad, "worst": worst}


def _ddp_metric_errors(got: dict, want: dict, k: int) -> dict:
    errs = {n: abs(got[n] - want[n]) / abs(want[n]) for n in ("live_loss", "epe")}
    errs.update({n: abs(got[n] - want[n]) for n in ("1px", "3px", "5px")})
    ok = (all(errs[n] <= DDP_LOSS_RTOL[k] for n in ("live_loss", "epe"))
          and all(errs[n] <= DDP_PX_ATOL for n in ("1px", "3px", "5px")))
    return {"errors": errs, "ok": ok}


def _ddp_torchrun(root: Path, name: str, steps: int) -> dict:
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    raft_stereo_tpu_torch.train --multihost`` in ``root``: the child's
    kernel launches in its loop (its log line), its per-step seconds (the
    ``device_step`` spans of its trace) and its final checkpoint."""
    import os
    import signal

    from raft_stereo_tpu_torch.runtime.checkpoint import read_manifest, verify_checkpoint

    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "1", "-m", "raft_stereo_tpu_torch.train", "--multihost", "--name", name,
            "--train_datasets", "sceneflow", "--num_steps", str(steps),
            "--corr_implementation", "alt", *TRAIN_RECIPE]
    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"ddp_path: torchrun ran past {DDP_TIMEOUT_S:.0f}s: {out[-4000:]}")
    wall = time.perf_counter() - t0
    (root / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"ddp_path: torchrun exit {proc.returncode}: {out[-4000:]}")
    found = re.findall(r"kernel launches in the loop \(rank 0\): (\{.*\})", out)
    if len(found) != 1:
        raise AssertionError(f"ddp_path: no launch count in the child's log: {out[-4000:]}")
    trace = json.loads((root / "runs" / name / "trace_host.json").read_text())
    step_s = [e["dur"] / 1e6 for e in trace["traceEvents"] if e.get("name") == "device_step"]
    final = str((root / "checkpoints" / name / name).resolve())
    return {"argv": argv[1:], "launches": json.loads(found[0]), "step_seconds": step_s,
            "wall_s_with_setup": wall, "final_verified": verify_checkpoint(final),
            "final_step": (read_manifest(final) or {}).get("step"),
            "nccl": "NCCL" in out or "nccl" in out}


def phase_ddp_path(tmp: Path, plain_alt: dict):
    """Data-parallel training (``parallel/mesh.py``, DDP in
    ``parallel/train_step.py``). First ``train --multihost`` through the
    real launcher on NCCL at world 1 with the train_path_alt recipe: K1
    must launch DDP_STEPS x 22 x 2 times in its loop, and its s/step
    stands beside train_path_alt's (DDP's cost at world 1). Then two gloo
    ranks sharing the card (NCCL refuses two ranks on one card) against one
    process at the same global batch (DDP_PARITY), the one process run
    after the ranks have exited; the planted per-rank mean must fail."""
    import dataclasses
    import os
    import socket

    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.parallel.train_step import onecycle_linear

    root = tmp / "train"
    if not (root / "datasets").exists():
        _write_things_tree(root)
    torch.cuda.empty_cache()
    run = _ddp_torchrun(root, "ddp_path", DDP_STEPS)
    first = 1  # as train_path_alt at 4 steps: the median of steps 2-4
    median = statistics.median(run["step_seconds"][first:])

    # the parity check: two ranks (processes of their own), then one process
    work = tmp / "ddp_parity"
    work.mkdir(exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(work / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                        "ddp-rank", str(r), str(work)], env=env, stdout=log,
                                       stderr=subprocess.STDOUT, start_new_session=True), log))
    try:
        for p, _ in procs:
            p.wait(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            os.killpg(p.pid, 9)
            p.wait()
        raise AssertionError("ddp_path: the parity ranks ran past their limit")
    finally:
        for _, log in procs:
            log.close()
    ranks_s = time.perf_counter() - t0
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"ddp_path: parity rank {r} exit {p.returncode}: "
                                 f"{(work / f'rank{r}.log').read_text()[-4000:]}")
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    one = _ddp_parity_run(False)
    torch.cuda.empty_cache()
    zero = _biases_before_instance_norm(RAFTStereo(dataclasses.replace(
        PRESETS["raftstereo"], corr_implementation="alt")))
    sched = onecycle_linear(2e-4, 200)  # TrainConfig(lr=2e-4, num_steps=100)
    steps = []
    for k, (m_one, t_one) in enumerate(one):
        got = torch.load(work / f"rank0_ddp_{k}.pt")
        steps.append({
            "metrics_ranks": ranks[0]["ddp"][k]["metrics"], "metrics_one": m_one,
            "metric_check": _ddp_metric_errors(ranks[0]["ddp"][k]["metrics"], m_one, k),
            "state_check": _ddp_mismatches(got, t_one, [sched(i) for i in range(k + 1)], zero),
            "ranks_bitwise": ranks[0]["ddp"][k]["digest"] == ranks[1]["ddp"][k]["digest"],
        })
    planted = {
        "metric_check": _ddp_metric_errors(ranks[0]["planted"][0]["metrics"], one[0][0], 0),
        "state_check": _ddp_mismatches(torch.load(work / "rank0_planted_0.pt"), one[0][1],
                                       [sched(0)], zero),
    }
    planted["state_check"]["over"] = len(planted["state_check"]["over"])
    for s in steps:
        s["state_check"]["over"] = dict(list(s["state_check"]["over"].items())[:5])
    res = {
        "phase": "ddp_path", "card": smi_line(),
        "entry": "python -m torch.distributed.run --standalone --nproc_per_node 1 "
                 "-m raft_stereo_tpu_torch.train --multihost",
        "backend": "nccl", "world": 1, "steps": DDP_STEPS, "launches": run["launches"],
        "s_per_step_median_steps_2_4": median, "step_seconds": run["step_seconds"],
        "train_path_alt_s_per_step": plain_alt["s_per_step_median_steps_3_6"],
        "ddp_over_plain": median / plain_alt["s_per_step_median_steps_3_6"],
        "wall_s_with_setup": run["wall_s_with_setup"], "final_verified": run["final_verified"],
        "final_step": run["final_step"],
        "parity": {"config": "raftstereo, corr alt, fp32, TF32 off, cuDNN deterministic",
                   **DDP_PARITY, "backend": "gloo, two ranks on cuda:0",
                   "ranks_wall_s": ranks_s,
                   "rank_peak_bytes": [r["max_memory_allocated_bytes"] for r in ranks],
                   "moment_rtol": TRAIN_STEP_GRAD_RTOL, "loss_rtol": DDP_LOSS_RTOL,
                   "px_atol": DDP_PX_ATOL, "steps": steps, "planted_per_rank_mean": planted},
    }
    emit(res)
    want_k1 = DDP_STEPS * TRAIN_ITERS * 2
    if run["launches"]["alt_corr"] != want_k1:
        raise AssertionError(f"ddp_path: K1 launched {run['launches']['alt_corr']} times in the "
                             f"torchrun run, expected {want_k1}")
    if not (run["final_verified"] and run["final_step"] == DDP_STEPS
            and len(run["step_seconds"]) == DDP_STEPS):
        raise AssertionError(f"ddp_path: the torchrun run {run}")
    for k, s in enumerate(steps):
        if not (s["metric_check"]["ok"] and not s["state_check"]["over"]
                and s["ranks_bitwise"]):
            raise AssertionError(f"ddp_path: two ranks disagree with one process at step "
                                 f"{k + 1}: {s}")
    if planted["metric_check"]["ok"] or not planted["state_check"]["over"]:
        raise AssertionError(f"ddp_path: the planted per-rank mean passes: {planted}")
    return res


# ------------------------------------- serving: scheduler, lifecycle, video

# sched_path: the interleaved stream, the engine pairs (by payload) in
# another order, with deadlines on some and priorities on others:
# (payload, deadline_s, priority). The deadlines are seconds apart, so the
# admission clock's jitter cannot reorder them.
SCHED_INTERLEAVED = ((6, None, 0), (0, None, 0), (7, 5.0, 0), (1, None, 2), (2, None, 0),
                     (8, None, 0), (3, 20.0, 0), (4, None, 5), (5, None, 0))
# the trickle: pairs of the rare bucket, alone, each followed by a pause
# longer than the scheduler's anti-starvation bound
SCHED_TRICKLE_MAX_WAIT_S = 0.5
SCHED_TRICKLE_PAUSE_S = 1.0
# the rate streams: the 9 engine pairs this many times over (36 pairs)
SCHED_RATE_REPEAT = 4

# sched_lifecycle (realtime packed engine, batch 4): the shed run stalls the
# first dispatch pass while all 9 pairs arrive, so the first
# LIFECYCLE_MAX_PENDING are admitted and the rest shed; the expiring drain
# stalls dispatch passes 2-6 past its bound.
LIFECYCLE_MAX_PENDING = 4
LIFECYCLE_SHED_STALL = "1:1500"
LIFECYCLE_DRAIN_STALL = "2,3,4,5,6:400"
LIFECYCLE_DRAIN_TIMEOUT_S = 0.25
LIFECYCLE_DRAIN_SLACK_S = 2.0  # past the bound: the stalled pass and an in-flight batch

# video_path: one moving scene, VIDEO_FRAMES frames at 540x960; the scene
# moves VIDEO_STEP px a frame; RAFT_FI_WARM_POISON poisons the warm reuse
# of frame VIDEO_POISON_FRAME (reuse ordinal = frame number: every frame
# after the first warm-starts once).
VIDEO_FRAMES = 8
VIDEO_HW = (540, 960)
VIDEO_STEP = 3
VIDEO_POISON_FRAME = 3
VIDEO_POISON_FILL = 40.0

# quality_canary: a tree of 12 scenes at 480x720, so --canary_every 4
# weaves 3 canaries (keys 1, 2, 3) into each run
QUALITY_SCENES = ((12, 480, 720),)
QUALITY_CANARY_EVERY = 4


def _recorded_groups(sched) -> list:
    """Record each group ``sched`` dispatches (its payloads, flush token
    dropped), in order."""
    groups = []
    inner = sched._next_group

    def record():
        group = inner()
        if group is not None:
            groups.append([r.payload for r in group if hasattr(r, "payload")])
        return group

    sched._next_group = record
    return groups


def _events_of(run_dir) -> list:
    path = Path(run_dir) / "events.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


def _bitwise(results, want, key=lambda k: k) -> dict:
    """Completed results against ``want`` (by ``key(payload)``), bitwise,
    with the largest difference of those that differ."""
    import numpy as np

    done = [k for k, r in results.items() if r.ok]
    diffs = [float(np.abs(results[k].output.astype(np.float64)
                          - want[key(k)].astype(np.float64)).max()) for k in done]
    return {"compared": len(done), "bitwise_equal": sum(d == 0 for d in diffs),
            "max_abs_diff": max(diffs, default=0.0)}


def phase_sched_path(tmp: Path):
    """The continuous-batching scheduler over the captured batch-4 engine of
    raftstereo-middlebury (32 iterations), on the engine pairs (6 at
    540x960, 3 at 480x640). The path: the FIFO stream through the scheduler
    on a fresh engine (counts set to 0 before, read after; K1's launches are
    the graphs' replayed launches). Then, on the same graphs: the plain
    engine over the same stream (the scheduler's outputs must equal it
    bitwise); the interleaved stream with deadlines and priorities
    (dispatch order recorded, each output bitwise the plain engine's); a
    trickle of the rare bucket with pauses above the scheduler's max wait,
    which must flush with reason max_wait; and pairs/s of the plain engine
    and the scheduler over 36-pair streams, in turns, no bound."""
    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model, make_engine
    from raft_stereo_tpu_torch.ops.pad import bucket_shape
    from raft_stereo_tpu_torch.runtime import infer, telemetry
    from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler, SchedRequest

    imgs = _engine_pairs(tmp)
    n_pairs = len(imgs)
    model = load_model(PRESETS["raftstereo-middlebury"], seed=SEED)
    engine = make_engine(model, 32, infer.InferOptions(batch=ENGINE_BATCH))

    def requests(order=range(n_pairs)):
        return [infer.InferRequest(payload=k, inputs=imgs[k]) for k in order]

    sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
    fifo_groups = _recorded_groups(sched)
    replayed0 = dict(engine.graphs.replayed_launches)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    served = {r.payload: r for r in sched.serve(iter(requests()))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrapper = _launches()
    launches = {k: v - replayed0[k] for k, v in engine.graphs.replayed_launches.items()}
    captures = engine.graphs.captures
    with _launches_kept():
        plain = {r.payload: r for r in engine.stream(iter(requests()))}
        want = {k: r.output for k, r in plain.items()}
        fifo = _bitwise(served, want)

        inter = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
        inter_groups = _recorded_groups(inter)
        stream = [SchedRequest(infer.InferRequest(payload=k, inputs=imgs[k]), priority=p,
                               deadline_s=d) for k, d, p in SCHED_INTERLEAVED]
        inter_out = {r.payload: r for r in inter.serve(iter(stream))}
        interleaved = _bitwise(inter_out, want)

        run_dir = tmp / "sched_trickle"
        tel = telemetry.install(telemetry.Telemetry(str(run_dir)))
        try:
            trickle = ContinuousBatchingScheduler(engine, max_wait_s=SCHED_TRICKLE_MAX_WAIT_S)
            rare_hw = tuple(ENGINE_PAIRS[-1][1:])
            rare = [k for k in range(n_pairs) if imgs[k][0].shape[:2] == rare_hw][:2]

            def paced():
                for k in rare:
                    yield infer.InferRequest(payload=k, inputs=imgs[k])
                    time.sleep(SCHED_TRICKLE_PAUSE_S)

            trickle_out = {r.payload: r for r in trickle.serve(paced())}
        finally:
            telemetry.uninstall(tel)
        flushes = [e for e in _events_of(run_dir) if e["event"] == "sched_flush"]

        rate_reqs = [infer.InferRequest(payload=i, inputs=imgs[i % n_pairs])
                     for i in range(n_pairs * SCHED_RATE_REPEAT)]
        rates = {"plain": [], "sched": []}
        for kind in ("plain", "sched", "sched", "plain"):
            stream_fn = (engine.stream if kind == "plain"
                         else ContinuousBatchingScheduler(engine).serve)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            done = sum(r.ok for r in stream_fn(iter(rate_reqs)))
            torch.cuda.synchronize()
            rates[kind].append(done / (time.perf_counter() - t1))
    res = {
        "phase": "sched_path", "entry": "runtime.scheduler.ContinuousBatchingScheduler.serve",
        "preset": "raftstereo-middlebury", "iters": 32, "batch": ENGINE_BATCH,
        "inputs": [[n, H, W] for n, H, W in ENGINE_PAIRS], "completed": sum(
            r.ok for r in served.values()), "wall_s_with_captures": wall, "captures": captures,
        "launches": launches, "launches_counted_as": "launches at capture x replays",
        "wrapper_launches_warmup_and_capture": wrapper, "fifo_groups": fifo_groups,
        "fifo_vs_plain": fifo, "interleaved_stream": [list(x) for x in SCHED_INTERLEAVED],
        "interleaved_groups": inter_groups, "interleaved_vs_plain": interleaved,
        "trickle": {"max_wait_s": SCHED_TRICKLE_MAX_WAIT_S, "pause_s": SCHED_TRICKLE_PAUSE_S,
                    "payloads": rare, "flushes": [
                        {k: e[k] for k in ("bucket", "valid", "reason", "wait_ms")}
                        for e in flushes], "vs_plain": _bitwise(trickle_out, want)},
        "pairs_per_s": rates, "pairs_a_rate_stream": len(rate_reqs),
        "engine_retries": engine.stats.retries, "card": smi_line(),
    }
    emit(res)
    if res["completed"] != n_pairs or captures != 2 or res["engine_retries"]:
        raise AssertionError(f"sched_path: {res['completed']} served, {captures} captures, "
                             f"{res['engine_retries']} retries")
    want_k1 = 3 * 32  # three batches of 32 lookups
    if launches["alt_corr"] != want_k1 or wrapper["alt_corr"] != 2 * 2 * 32:
        raise AssertionError(f"sched_path: K1 launches {launches}, wrapper {wrapper}")
    for name, cmp in (("fifo", fifo), ("interleaved", interleaved),
                      ("trickle", res["trickle"]["vs_plain"])):
        n_want = len(rare) if name == "trickle" else n_pairs
        if cmp["compared"] != n_want or cmp["bitwise_equal"] != n_want:
            raise AssertionError(f"sched_path: {name} against the plain engine: {cmp}")
    if sorted(sum(inter_groups, [])) != list(range(n_pairs)):
        raise AssertionError(f"sched_path: interleaved groups {inter_groups}")
    if not any(e["reason"] == "max_wait" and e["bucket"] == list(bucket_shape(*rare_hw))
               for e in flushes):
        raise AssertionError(f"sched_path: no max_wait flush of the rare bucket: {flushes}")
    return res


def phase_sched_lifecycle(tmp: Path):
    """Shedding, the drain and the stall injector on the realtime-packed
    engine (batch 4, 7 iterations), one captured engine for every run. A
    clean plain run gives the reference outputs. Shed: --max_pending 4 with
    RAFT_FI_SCHED_STALL stalling the first dispatch pass 1.5 s while the 9
    pairs arrive: pairs 0-3 served (the first result after the stall), 4-8
    typed ShedErrors (queue_full). Drain within the bound: a stream whose
    source waits after 8 requests, stopped after 4 results: the request
    pulled as the stop lands is the last admitted (9), and every admitted
    request completes. Drain past the bound: 18 requests, dispatch passes
    2-6 stalled 0.4 s, the bound 0.25 s, stopped after 2 results: every
    admitted request resolves once, completed or DrainedError, the last
    within the bound and its slack. Every completed output bitwise the
    clean run's."""
    import threading

    import torch

    from raft_stereo_tpu_torch.evaluate import make_engine
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.runtime import faultinject, infer
    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.scheduler import (ContinuousBatchingScheduler,
                                                         DrainedError, ShedError)

    imgs = _engine_pairs(tmp)
    n_pairs = len(imgs)
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    runs = {}
    try:
        model = _realtime_packed_model()
        engine = make_engine(model, 7, infer.InferOptions(batch=ENGINE_BATCH))

        def requests(n):
            return [infer.InferRequest(payload=k, inputs=imgs[k % n_pairs]) for k in range(n)]

        with _launches_kept(), _injector():
            want = {r.payload: r.output for r in engine.stream(iter(requests(n_pairs)))}

        def ref(k):
            return k % n_pairs

        # shed
        replayed0 = dict(engine.graphs.replayed_launches)
        with _injector("RAFT_FI_SCHED_STALL", LIFECYCLE_SHED_STALL):
            _zero_launches()
            sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0,
                                                max_pending=LIFECYCLE_MAX_PENDING)
            t0 = time.perf_counter()
            first, out = None, {}
            for r in sched.serve(iter(requests(n_pairs))):
                if r.ok and first is None:
                    first = time.perf_counter() - t0
                out[r.payload] = r
            passes = faultinject.sched_dispatch_attempts()
        launches = {k: v - replayed0[k] for k, v in engine.graphs.replayed_launches.items()}
        shed = sorted(k for k, r in out.items() if isinstance(r.error, ShedError))
        runs["shed"] = {
            "max_pending": LIFECYCLE_MAX_PENDING, "injector": f"RAFT_FI_SCHED_STALL="
            f"{LIFECYCLE_SHED_STALL}", "completed": sorted(k for k, r in out.items() if r.ok),
            "shed": shed, "reasons": sorted({out[k].error.reason for k in shed}),
            "stats_shed": dict(sched.stats.shed_reasons), "first_result_s": first,
            "dispatch_passes": passes, **_bitwise(out, want, ref)}

        # drain within the bound
        shutdown = GracefulShutdown()  # not entered: the stop is requested in-process
        drain = ServeDrain(shutdown, timeout_s=30.0, label="chip_smoke")
        sched = ContinuousBatchingScheduler(engine, max_wait_s=2.0)
        drain.attach(sched)
        accepted, out = [], {}

        def gated(n):
            # 8 requests, then the source waits for the stop: the request
            # pulled as the stop lands is the last one admitted
            for i, r in enumerate(requests(n)):
                if i == 8:
                    deadline = time.monotonic() + 60.0
                    while not drain.draining and time.monotonic() < deadline:
                        time.sleep(0.01)
                accepted.append(r.payload)
                yield r

        with _launches_kept(), _injector():
            for r in sched.serve(drain.wrap_source(gated(4 * n_pairs))):
                drain.note_result(r)
                out[r.payload] = r
                if len(out) == 4:
                    shutdown.request_stop()
        runs["drain"] = {"timeout_s": 30.0, "accepted": len(accepted), "resolved": len(out),
                         "completed": sum(r.ok for r in out.values()),
                         "finish": drain.finish(), **_bitwise(out, want, ref)}
        runs["drain"]["all_accepted_resolved"] = sorted(out) == sorted(accepted)

        # drain past the bound
        shutdown = GracefulShutdown()
        drain = ServeDrain(shutdown, timeout_s=LIFECYCLE_DRAIN_TIMEOUT_S, label="chip_smoke")
        sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
        drain.attach(sched)
        accepted, out, t_stop, t_last = [], {}, None, None

        def counted(n):
            for r in requests(n):
                accepted.append(r.payload)
                yield r

        with _launches_kept(), _injector("RAFT_FI_SCHED_STALL", LIFECYCLE_DRAIN_STALL):
            for r in sched.serve(drain.wrap_source(counted(2 * n_pairs))):
                drain.note_result(r)
                out[r.payload] = r
                t_last = time.perf_counter()
                if len(out) == 2 and t_stop is None:
                    t_stop = t_last
                    shutdown.request_stop()
        drained = sorted(k for k, r in out.items() if isinstance(r.error, DrainedError))
        runs["drain_expired"] = {
            "timeout_s": LIFECYCLE_DRAIN_TIMEOUT_S, "injector": f"RAFT_FI_SCHED_STALL="
            f"{LIFECYCLE_DRAIN_STALL}", "accepted": len(accepted), "resolved": len(out),
            "completed": sorted(k for k, r in out.items() if r.ok), "drained": drained,
            "stop_to_last_result_s": t_last - t_stop, "finish": drain.finish(),
            "all_accepted_resolved": sorted(out) == sorted(accepted), **_bitwise(out, want, ref)}
        del engine
        torch.cuda.empty_cache()
    finally:
        extractor._ENABLE_PACKED = saved
    res = {"phase": "sched_lifecycle", "preset": "raftstereo-realtime", "packed_stage": True,
           "iters": 7, "batch": ENGINE_BATCH, "launches": launches,
           "launches_counted_as": "launches at capture x replays (the shed run)",
           "runs": runs, "card": smi_line()}
    emit(res)
    sh = runs["shed"]
    if (sh["completed"] != list(range(LIFECYCLE_MAX_PENDING))
            or sh["shed"] != list(range(LIFECYCLE_MAX_PENDING, n_pairs))
            or sh["reasons"] != ["queue_full"] or sh["first_result_s"] < 1.5):
        raise AssertionError(f"sched_lifecycle: the shed run {sh}")
    dr, de = runs["drain"], runs["drain_expired"]
    if not (dr["all_accepted_resolved"] and dr["completed"] == dr["resolved"]
            and dr["accepted"] == 9 and dr["finish"]["drained"] == 0):
        raise AssertionError(f"sched_lifecycle: the drain within its bound {dr}")
    if not (de["all_accepted_resolved"] and de["drained"]
            and len(de["completed"]) + len(de["drained"]) == de["resolved"]
            and de["finish"]["drained"] == len(de["drained"])
            and de["stop_to_last_result_s"] <= LIFECYCLE_DRAIN_TIMEOUT_S
            + LIFECYCLE_DRAIN_SLACK_S):
        raise AssertionError(f"sched_lifecycle: the drain past its bound {de}")
    for name, r in runs.items():
        if r["bitwise_equal"] != r["compared"] or not r["compared"]:
            raise AssertionError(f"sched_lifecycle {name}: {r['bitwise_equal']} of "
                                 f"{r['compared']} outputs equal the clean run's")
    return res


def _write_video(root: Path, n: int, H: int, W: int, d: int = 24,
                 step: int = VIDEO_STEP, seed: int = SEED + 40):
    """``n`` frames of one moving scene as PNGs in ``root/frameK/im{0,1}``:
    one smoothed random texture, panned ``step`` px a frame, the right view
    the left shifted by ``d``."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    pad = 64
    tex = rng.rand(H, W + 2 * pad + n * step, 3)
    for axis in (0, 1):
        tex = sum(np.roll(tex, s, axis=axis) for s in range(-2, 3)) / 5.0
    tex = (tex * 255).astype(np.uint8)
    for k in range(n):
        x = pad + k * step
        frame = root / f"frame{k}"
        frame.mkdir(parents=True)
        Image.fromarray(np.ascontiguousarray(tex[:, x:x + W])).save(frame / "im0.png")
        Image.fromarray(np.ascontiguousarray(tex[:, x + d:x + d + W])).save(frame / "im1.png")


def _padded(arrays):
    """Host [H, W, C] arrays → batch-1 tensors on the card, edge-padded to
    /32 as the engine pads them, and their padder."""
    import torch

    from raft_stereo_tpu_torch.ops.pad import BatchPadder

    padder = BatchPadder([arrays[0].shape[:2]], divis_by=32)
    return padder, [torch.from_numpy(padder.pad([x])).cuda() for x in arrays]


def phase_video_path(tmp: Path):
    """``demo.main --serve_video --adaptive_iters --converge_eps E`` with
    raftstereo-realtime and the packed stage, batch 1, over VIDEO_FRAMES
    frames at 540x960 of one moving scene. E is picked from frame 0's
    per-step deltas as ``phase_early_exit`` picks it (the deltas of a probe
    forward, cold, as frame 0 is served). Checks: session_warm_start reads
    [False, True x 7]; each output [540, 960, 1]; frame 0's iterations as
    the probe predicts; K1's (eager) launches = the sum of iters_done, K3's
    4 a frame. Warm against cold iterations is recorded, not bounded
    (random weights do not contract). Then the same with converge_eps 0: one
    three-input graph captured, each frame's output bitwise the eager
    forward on the same images and warm slot; then RAFT_FI_WARM_POISON on
    frame 3: frames 0-2 bitwise the clean run's, frame 3 the eager forward
    on the constant warm slot, unlike the clean frame 3, and every frame
    served."""
    import dataclasses

    import numpy as np
    import torch

    from raft_stereo_tpu_torch import demo
    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.demo import load_image
    from raft_stereo_tpu_torch.evaluate import load_model, make_adaptive_forward
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.ops import fused_update
    from raft_stereo_tpu_torch.runtime.scheduler import default_warm_fn

    frames = tmp / "video"
    if not frames.exists():
        _write_video(frames, VIDEO_FRAMES, *VIDEO_HW)
    imgs = [(load_image(str(frames / f"frame{k}" / "im0.png"))[0],
             load_image(str(frames / f"frame{k}" / "im1.png"))[0]) for k in range(VIDEO_FRAMES)]
    H, W = imgs[0][0].shape[:2]
    iters = 7
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    try:
        with _launches_kept():
            probe = load_model(dataclasses.replace(PRESETS["raftstereo-realtime"],
                                                   converge_eps=1e-30), seed=SEED)
            deltas = []
            inner = fused_update.batch_max_delta

            def record(delta):
                v = inner(delta)
                deltas.append(float(v))
                return v

            fused_update.batch_max_delta = record
            try:
                _, (a, b) = _padded(imgs[0])
                probe(a, b, iters=iters)
            finally:
                fused_update.batch_max_delta = inner
            del probe
        k = next((i for i in range(1, len(deltas)) if deltas[i] < min(deltas[:i])), 1)
        eps = 0.5 * (min(deltas[:k]) + deltas[k])
        frame0_iters = next((i + 1 for i, dd in enumerate(deltas) if dd < eps), len(deltas)) + 1

        def run_demo(name, converge_eps, env=None):
            out = tmp / f"out_{name}"
            tel = tmp / f"tel_{name}"
            argv = ["--preset", "raftstereo-realtime", "--valid_iters", str(iters),
                    "--infer_batch", "1", "--serve_video", "--adaptive_iters",
                    "--converge_eps", repr(converge_eps), "--telemetry_dir", str(tel),
                    "-l", str(frames / "*" / "im0.png"), "-r", str(frames / "*" / "im1.png"),
                    "--output_directory", str(out), "--save_numpy"]
            with _injector(*(env or ())):
                _zero_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run = demo.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                wrapper = _launches()
            events = _events_of(tel)
            warm = {e["frame"]: e for e in events if e["event"] == "session_warm_start"}
            exits = {e["trace_id"]: e for e in events if e["event"] == "refine_early_exit"}
            done = [exits[warm[f]["trace_id"]]["iters_done"] if warm[f]["trace_id"] in exits
                    else iters for f in sorted(warm)]
            disps = [np.load(out / f"frame{f}.npy") for f in range(VIDEO_FRAMES)]
            return run, {"wall_s": wall, "wrapper_launches": wrapper,
                         "warm": [warm[f]["warm"] for f in sorted(warm)],
                         "warm_reasons": [warm[f]["reason"] for f in sorted(warm)],
                         "iters_done": done, "ms_per_frame": [1e3 * s for s in run.seconds],
                         "shapes": [list(x) for x in run.shapes], "saved": run.saved}, disps

        adaptive_run, adaptive, _ = run_demo("video_adaptive", eps)
        model = adaptive_run.model
        with _launches_kept():
            cold_iters = []
            fwd = make_adaptive_forward(model, iters, video=True)
            for f in range(VIDEO_FRAMES):
                _, (a, b, z) = _padded((*imgs[f], np.zeros((H, W, 2), np.float32)))
                cold_iters.append(int(round(float(fwd(a, b, z)[0, 0, 0, 1]))))
        del adaptive_run, model, fwd
        captured_run, captured, disps = run_demo("video_captured", 0.0)
        graphs = captured_run.graphs
        launches = dict(graphs.replayed_launches)
        model = captured_run.model
        with _launches_kept():
            fwd = make_adaptive_forward(model, iters, video=True)

            def eager(f, slot):
                padder, (a, b, s) = _padded((*imgs[f], slot))
                return padder.unpad(fwd(a, b, s).cpu().numpy(), 0)[:, :, 0]

            warm_fn_ms = []
            for d in disps[:3]:  # the session's host-side warm fill, timed
                t0 = time.perf_counter()
                default_warm_fn(d)
                warm_fn_ms.append(1e3 * (time.perf_counter() - t0))
            slots = [np.zeros((H, W, 2), np.float32)] + [default_warm_fn(d) for d in disps[:-1]]
            replay_equal = [bool(np.array_equal(eager(f, slots[f]), disps[f]))
                            for f in range(VIDEO_FRAMES)]
            poison_run, poison, pdisps = run_demo(
                "video_poison", 0.0, ("RAFT_FI_WARM_POISON",
                                      f"{VIDEO_POISON_FRAME}:{VIDEO_POISON_FILL}"))
            const = np.full((H, W, 2), VIDEO_POISON_FILL, np.float32)
            poisoned_is_eager_on_fill = bool(np.array_equal(
                eager(VIDEO_POISON_FRAME, const), pdisps[VIDEO_POISON_FRAME]))
        before_equal = [bool(np.array_equal(pdisps[f], disps[f]))
                        for f in range(VIDEO_POISON_FRAME)]
        poison_differs = not np.array_equal(pdisps[VIDEO_POISON_FRAME], disps[VIDEO_POISON_FRAME])
        captured.update(captures=graphs.captures, replays=graphs.replays,
                        retries=captured_run.engine.stats.retries,
                        replay_equals_eager_bitwise=replay_equal)
        del captured_run, poison_run, model, fwd, graphs
        torch.cuda.empty_cache()
    finally:
        extractor._ENABLE_PACKED = saved
    adaptive["launches"] = adaptive["wrapper_launches"]
    res = {"phase": "video_path", "entry": "raft_stereo_tpu_torch.demo.main --serve_video",
           "preset": "raftstereo-realtime", "packed_stage": True, "iters": iters,
           "frames": VIDEO_FRAMES, "size": [H, W], "scene_step_px": VIDEO_STEP,
           "probe_deltas_frame0": deltas, "converge_eps": eps,
           "frame0_iters_predicted": frame0_iters, "adaptive": adaptive,
           "cold_iters": cold_iters, "warm_fn_ms": warm_fn_ms, "launches": adaptive["launches"],
           "launches_counted_as": "wrapper launches (eager forward)",
           "captured": captured, "captured_launches": launches,
           "poison": {"injector": f"RAFT_FI_WARM_POISON={VIDEO_POISON_FRAME}:"
                      f"{VIDEO_POISON_FILL}", "warm": poison["warm"], "saved": poison["saved"],
                      "frames_before_bitwise_clean": before_equal,
                      "poisoned_frame_is_eager_on_the_fill": poisoned_is_eager_on_fill,
                      "poisoned_frame_differs_from_clean": poison_differs},
           "card": smi_line()}
    emit(res)
    want_warm = [False] + [True] * (VIDEO_FRAMES - 1)
    for name, r in (("adaptive", adaptive), ("captured", captured), ("poison", poison)):
        if r["warm"] != want_warm or r["saved"] != VIDEO_FRAMES:
            raise AssertionError(f"video_path {name}: warm {r['warm']}, {r['saved']} saved")
    if adaptive["shapes"] != [[H, W, 1]] * VIDEO_FRAMES:
        raise AssertionError(f"video_path: output shapes {adaptive['shapes']}")
    if adaptive["iters_done"][0] != frame0_iters:
        raise AssertionError(f"video_path: frame 0 ran {adaptive['iters_done'][0]} "
                             f"iterations, the probe predicts {frame0_iters}")
    want = {"alt_corr": sum(adaptive["iters_done"]), "fused_update": 0,
            "packed_conv": K3_PER_TRUNK * VIDEO_FRAMES}
    if adaptive["launches"] != want:
        raise AssertionError(f"video_path: launches {adaptive['launches']}, expected {want}")
    if (captured["captures"] != 1 or captured["replays"] != VIDEO_FRAMES
            or captured["retries"] or not all(replay_equal)):
        raise AssertionError(f"video_path: captured {captured}")
    if launches != {"alt_corr": iters * VIDEO_FRAMES, "fused_update": 0,
                    "packed_conv": K3_PER_TRUNK * VIDEO_FRAMES}:
        raise AssertionError(f"video_path: captured launches {launches}")
    if not (all(before_equal) and poisoned_is_eager_on_fill and poison_differs):
        raise AssertionError(f"video_path: the poisoned run {res['poison']}")
    return res


def phase_update_variables(tmp: Path):
    """``InferenceEngine.update_variables`` on the captured realtime-packed
    engine: after an update to other weights (seed + 1), the engine's
    replays equal, bitwise, a fresh engine built on those weights, with no
    new capture, and differ from the old weights' outputs."""
    import torch

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model, make_engine
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.runtime import infer

    imgs = _engine_pairs(tmp)
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    try:
        engine = make_engine(_realtime_packed_model(), 7, infer.InferOptions(batch=ENGINE_BATCH))

        def serve(eng):
            return {r.payload: r for r in eng.stream(iter(
                [infer.InferRequest(payload=k, inputs=p) for k, p in enumerate(imgs)]))}

        with _launches_kept():
            before = serve(engine)
            captures = engine.graphs.captures
            new = load_model(PRESETS["raftstereo-realtime"], seed=SEED + 1)
            t0 = time.perf_counter()
            engine.update_variables(new.state_dict())
            torch.cuda.synchronize()
            update_ms = 1e3 * (time.perf_counter() - t0)
            replayed0 = dict(engine.graphs.replayed_launches)
            _zero_launches()
            after = serve(engine)
            launches = {k: v - replayed0[k] for k, v in engine.graphs.replayed_launches.items()}
            fresh = serve(make_engine(new, 7, infer.InferOptions(batch=ENGINE_BATCH)))
        vs_fresh = _bitwise(after, {k: r.output for k, r in fresh.items()})
        vs_old = _bitwise(after, {k: r.output for k, r in before.items()})
        res = {"phase": "update_variables", "preset": "raftstereo-realtime",
               "packed_stage": True, "batch": ENGINE_BATCH, "pairs": len(imgs),
               "tensors": len(new.state_dict()), "update_ms": update_ms,
               "captures_before": captures, "captures_after": engine.graphs.captures,
               "launches": launches, "launches_counted_as": "launches at capture x replays",
               "vs_fresh_engine": vs_fresh, "vs_old_weights": vs_old, "card": smi_line()}
        del engine, fresh, new
        torch.cuda.empty_cache()
    finally:
        extractor._ENABLE_PACKED = saved
    emit(res)
    if res["captures_after"] != res["captures_before"] or res["captures_before"] != 2:
        raise AssertionError(f"update_variables: captures {captures} -> "
                             f"{res['captures_after']}")
    if vs_fresh["bitwise_equal"] != len(imgs) or vs_old["bitwise_equal"] != 0:
        raise AssertionError(f"update_variables: against a fresh engine {vs_fresh}, against "
                             f"the old weights {vs_old}")
    return res


def phase_quality_canary(tmp: Path):
    """``evaluate.main --dataset eth3d --sched --canary_every 4 --golden_dir
    G`` (raftstereo-realtime) on a synthetic ETH3D tree of 12 scenes, so 3
    canaries (keys 1, 2, 3) ride each run: the first run captures their
    goldens and saves them in G, the second loads them and every canary
    passes; a copy of G with every golden moved by one pixel (along W) makes
    each canary fail, and the third failure latches (--canary_latch 3: the
    canary_latch event and a blackbox dump). The drift sketch counts the 12
    user results, never a canary; the metrics are the same in the first two
    runs."""
    import numpy as np

    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.runtime.quality import QualityConfig

    root = _eth3d_tree(tmp, "eth3d_quality", QUALITY_SCENES)
    golden, moved = tmp / "goldens", tmp / "goldens_moved"
    n_users = sum(n for n, _, _ in QUALITY_SCENES)
    runs = {}

    def run(name, golden_dir):
        tel = tmp / f"tel_{name}"
        argv = ["--dataset", "eth3d", "--preset", "raftstereo-realtime", "--valid_iters", "7",
                "--sched", "--canary_every", str(QUALITY_CANARY_EVERY),
                "--golden_dir", str(golden_dir), "--telemetry_dir", str(tel)]
        with _chdir(root), _launches_kept():
            _zero_launches()
            t0 = time.perf_counter()
            metrics = evaluate.main(argv)
            wall = time.perf_counter() - t0
            wrapper = _launches()
        q = evaluate.last_quality()
        events = _events_of(tel)
        results = [e for e in events if e["event"] == "canary_result"]
        blackbox = tel / "blackbox.json"
        runs[name] = {
            "metrics": metrics, "wall_s": wall, "wrapper_launches": wrapper,
            "canaries": q["canaries"], "injected": q["canaries_injected"],
            "user_results": q["user_results"],
            "sketch_results": q["tiers"]["serving"]["reference"]["counters"]["results"],
            "outcomes": [(e["key"], e["outcome"], e["epe"], e["consecutive"]) for e in results],
            "latch_events": [e["consecutive"] for e in events if e["event"] == "canary_latch"],
            "blackbox_trigger": (json.loads(blackbox.read_text())["trigger"]
                                 if blackbox.exists() else None)}

    run("first", golden)
    path = golden / f"canary_goldens_{QUALITY_SCENES[0][1]}x{QUALITY_SCENES[0][2]}.npz"
    run("second", golden)
    moved.mkdir()
    shift = {}
    with np.load(path) as z:
        arrays = {name: np.roll(z[name], 1, axis=1) for name in z.files}
        shift = {name: float(np.abs(arrays[name].astype(np.float64) - z[name]).mean())
                 for name in z.files}
    np.savez(moved / path.name, **arrays)
    run("moved", moved)
    res = {"phase": "quality_canary", "entry": "raft_stereo_tpu_torch.evaluate.main --sched",
           "preset": "raftstereo-realtime", "scenes": [list(x) for x in QUALITY_SCENES],
           "canary_every": QUALITY_CANARY_EVERY, "canary_tol_px": QualityConfig().canary_tol,
           "check": "toleranced (bf16: goldens are bit-exact only on the fp32 path)",
           "golden_file": path.name, "moved_mean_abs_px": shift, "runs": runs,
           "card": smi_line()}
    emit(res)
    first, second, mv = runs["first"], runs["second"], runs["moved"]
    n_can = n_users // QUALITY_CANARY_EVERY
    if [o[1] for o in first["outcomes"]] != ["captured"] * n_can or not path.exists():
        raise AssertionError(f"quality_canary: the first run {first['outcomes']}")
    if [o[1] for o in second["outcomes"]] != ["pass"] * n_can:
        raise AssertionError(f"quality_canary: the second run {second['outcomes']}")
    if ([o[1] for o in mv["outcomes"]] != ["fail"] * n_can or mv["latch_events"] != [3]
            or mv["canaries"]["latched"] != ["serving"] or mv["blackbox_trigger"]
            != "canary_latch"):
        raise AssertionError(f"quality_canary: the moved goldens {mv}")
    for name, r in runs.items():
        if (r["user_results"], r["sketch_results"], r["injected"]) != (n_users, n_users, n_can):
            raise AssertionError(f"quality_canary {name}: {r['user_results']} user results, "
                                 f"{r['sketch_results']} in the sketch, {r['injected']} canaries")
    if first["metrics"] != second["metrics"] or not all(
            math.isfinite(v) for v in first["metrics"].values()):
        raise AssertionError(f"quality_canary: metrics {first['metrics']} vs "
                             f"{second['metrics']}")
    return res


def phase_blackbox(tmp: Path):
    """SIGUSR2 during a scheduled video serve (``make_serving`` with --sched
    and --serve_video on the realtime-packed model, batch 4): the source
    pauses after three session frames and one sessionless pair; once their
    results are in, the signal. The dump must parse and hold the
    ``engine:serving``, ``scheduler:serving`` and ``sessions`` providers and
    every thread's stack with its role (main, admit, stager, introspect);
    then the serve finishes, every request served."""
    import os
    import signal
    import threading

    from raft_stereo_tpu_torch.evaluate import make_serving
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.runtime import blackbox, infer, telemetry
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    imgs = _engine_pairs(tmp)
    run_dir = tmp / "blackbox_run"
    saved = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    tel = telemetry.install(telemetry.Telemetry(str(run_dir)))
    dumper = blackbox.install(blackbox.BlackboxDumper(str(run_dir)))
    gate = threading.Event()
    results = []
    worker = None
    try:
        dumper.watch_signal()
        engine, stream = make_serving(_realtime_packed_model(), 7, infer.InferOptions(
            batch=ENGINE_BATCH, sched=True, sched_max_wait=0.2, adaptive_iters=True,
            video=True))

        def source():
            for k in range(3):
                yield SchedRequest(infer.InferRequest(payload=f"frame{k}", inputs=imgs[k]),
                                   session="video")
            yield infer.InferRequest(payload="plain", inputs=imgs[6])
            gate.wait(timeout=120.0)
            for k in range(3, 6):
                yield SchedRequest(infer.InferRequest(payload=f"frame{k}", inputs=imgs[k]),
                                   session="video")

        def consume():
            with _launches_kept():
                for r in stream(source()):
                    results.append(r)

        # the consumer on a worker: the main thread, where the signal lands,
        # signals a live serve
        worker = threading.Thread(target=consume, name="chip-smoke-consumer")
        worker.start()
        deadline = time.monotonic() + 120.0
        while len(results) < 4 and time.monotonic() < deadline and worker.is_alive():
            time.sleep(0.05)
        served_before = len(results)
        os.kill(os.getpid(), signal.SIGUSR2)
        dumped = dumper.wait_for_dump(1, timeout_s=30.0)
        gate.set()
        worker.join(timeout=120.0)
    finally:
        gate.set()
        if worker is not None:
            worker.join(timeout=30.0)
        blackbox.uninstall(dumper)
        telemetry.uninstall(tel)
        extractor._ENABLE_PACKED = saved
    doc = json.loads((run_dir / blackbox.BLACKBOX_NAME).read_text())
    roles = {}
    for th in doc["threads"]:
        roles.setdefault(th["role"], []).append(th["name"])
    res = {"phase": "blackbox", "served_before_signal": served_before, "dumped": dumped,
           "trigger": doc["trigger"], "reason": doc["reason"], "dump_ms": doc["dump_ms"],
           "providers": sorted(doc["snapshots"]), "roles": roles,
           "ring_events": len(doc["ring"]["events"]),
           "sessions_snapshot": doc["snapshots"].get("sessions"),
           "scheduler_snapshot_stats": (doc["snapshots"].get("scheduler:serving") or {}).get(
               "stats"),
           "served": sorted(str(r.payload) for r in results if r.ok),
           "consumer_alive": worker.is_alive(), "captures": engine.graphs.captures,
           "engine_retries": engine.stats.retries, "card": smi_line()}
    emit(res)
    if not (dumped and served_before == 4 and doc["trigger"] == "signal"
            and doc["reason"] == "SIGUSR2"):
        raise AssertionError(f"blackbox: dump {dumped}, {served_before} served before the "
                             f"signal, trigger {doc['trigger']}")
    if not {"engine:serving", "scheduler:serving", "sessions"} <= set(doc["snapshots"]):
        raise AssertionError(f"blackbox: providers {sorted(doc['snapshots'])}")
    names = {th["name"]: th["role"] for th in doc["threads"]}
    want = {"MainThread": "main", "sched-admit": "admit", "session-router": "admit",
            "infer-stager": "stager", "blackbox-dump": "introspect"}
    if any(names.get(k) != v for k, v in want.items()) or not all(
            th["stack"] for th in doc["threads"] if th["name"] in want):
        raise AssertionError(f"blackbox: thread roles {names}")
    if res["consumer_alive"] or len(res["served"]) != 7 or res["engine_retries"]:
        raise AssertionError(f"blackbox: the serve ended with {res['served']}")
    return res


# ------------------------------------------------------- the MADNet2 family

# FlyingThings3D TEST pairs for mad_eval: 540x960, pair 1 at 600x900, all
# served in the 640x1024 bucket (the first batch mixes two pad offsets).
MAD_EVAL_PAIRS = 8
MAD_EVAL_PAIR1_SHAPE = (600, 900)
MAD_EVAL_BATCH = 4
MAD_EVAL_VARIANTS = (("madnet2", []), ("madnet2_bf16", ["--mixed_precision"]),
                     ("fusion", ["--fusion"]))
# pairs/s of the held batch-4 engine over this many in-memory requests (the
# decoded pairs repeated), after a warm-up stream of as many
MAD_STREAM_REQUESTS = 256
# batched against per-image disparities, max px: cuDNN may pick another
# algorithm for another batch, and TF32 is on in the CLI runs (its 10-bit
# products), bf16 rounds every conv's output. Measured on an H100 (540x960
# only): 0.017 (fp32), 0.145 (bf16), 0.017 (Fusion); the limits are about 6x
# and 3.5x those, and two planted routing faults (a rolled batch, an unpad
# window two rows off) must exceed them.
MAD_PER_IMAGE_TOL = {"madnet2": 0.1, "madnet2_bf16": 0.5, "fusion": 0.1}
# the card against the CPU, fp32 with TF32 off: summation order only, per
# level max |diff| <= MAD_PARITY_RTOL * max |CPU| + MAD_PARITY_ATOL
MAD_PARITY_RTOL, MAD_PARITY_ATOL = 1e-4, 1e-6
MAD_PARITY_SHAPE = (2, 384, 1280)
# serve_adaptive on KITTI 2015's frame size with the shifted domain
MAD_SERVE_ARGV = ["--source", "synthetic", "--synthetic_size", "375", "1242",
                  "--adapt_mode", "mad", "--adapt_every", "4", "--infer_batch", "2",
                  "--domain_shift", "1.8:0.65:8"]
MAD_SERVE_REQUESTS = 64
MAD_TRAIN_PAIRS = 12  # synthetic FlyingThings3D TRAIN pairs at 540x960
MAD_TRAIN_STEPS = 6
MAD_ADAPT_FRAMES = 8


def _no_kernel_launched(phase: str, launches: dict) -> None:
    """The MADNet2 family runs none of K1-K3."""
    if any(launches.values()):
        raise AssertionError(f"{phase}: a RAFT-Stereo kernel launched: {launches}")


def _things_test_pairs(root: Path):
    """The decoded TEST pairs (with their GT) of the tree under ``root``."""
    from raft_stereo_tpu_torch.data import datasets

    with _chdir(root):
        ds = datasets.SceneFlowDatasets(dstype="frames_finalpass", things_test=True)
        return [ds[i] for i in range(len(ds))]


def phase_mad_eval(tmp: Path):
    """``evaluate_mad.main`` on a synthetic FlyingThings3D TEST tree (8 pairs
    at 540x960, pair 1 at 600x900, the 640x1024 bucket) through the captured
    engine at batch 4 and with ``--per_image``, for MADNet2 fp32,
    ``--mixed_precision`` and ``--fusion`` (seeded weights): metrics, device
    ms a pair, captures and replays, peak memory; then, on the same model and
    pairs, batched against per-image disparities (within MAD_PER_IMAGE_TOL,
    which two planted routing faults must exceed), one batch replayed
    against its eager forward, bitwise, and the held batch-4 engine's pairs/s
    over MAD_STREAM_REQUESTS in-memory requests."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import evaluate_mad
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.ops.pad import BatchPadder
    from raft_stereo_tpu_torch.runtime import infer

    root = tmp / "mad_things"
    _write_things_tree(root, n=MAD_EVAL_PAIRS, split="TEST", pair1_shape=MAD_EVAL_PAIR1_SHAPE)
    pairs = _things_test_pairs(root)
    out = []
    _zero_launches()
    for name, flags in MAD_EVAL_VARIANTS:
        fusion = "--fusion" in flags
        runs = {}
        for mode, extra in (("engine", ["--infer_batch", str(MAD_EVAL_BATCH)]),
                            ("per_image", ["--per_image"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with _chdir(root):
                t0 = time.perf_counter()
                metrics = evaluate_mad.main(flags + extra)
                wall = time.perf_counter() - t0
            eng = evaluate_mad.last_engine()
            s = eng.stats
            runs[mode] = {
                "metrics": metrics, "wall_s": wall, "captures": eng.graphs.captures,
                "capture_s": eng.graphs.capture_s, "replays": eng.graphs.replays,
                "device_ms_per_pair": (sum(s.batch_ms) / sum(s.batch_valid)
                                       if s.batch_valid else None),
                "completed": s.images, "failed": s.failed,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
            del eng
        # the same model and pairs, through engines held here
        model = make_madnet2(mixed_precision="--mixed_precision" in flags, fusion=fusion,
                             seed=0, device="cuda")
        reqs = [infer.InferRequest(payload=i, inputs=p[:2] + ((p[2],) if fusion else ()))
                for i, p in enumerate(pairs)]
        outs = {}
        for batch in (1, MAD_EVAL_BATCH):
            eng = evaluate_mad.make_mad_engine(model, fusion, infer.InferOptions(batch=batch))
            outs[batch] = {r.payload: r.output for r in eng.stream(iter(reqs))}
        one, many = outs[1], outs[MAD_EVAL_BATCH]
        diff = max(float(np.abs(many[i] - one[i]).max()) for i in one)
        # planted routing faults: each 540x960 pair's per-image output against
        # the next 540x960 pair's batched one, and against its own batched
        # output read two rows down
        same = [i for i in one if one[i].shape == one[0].shape]
        faults = {
            "rolled_batch_max_px": min(float(np.abs(one[i] - many[same[(k + 1) % len(same)]])
                                             .max()) for k, i in enumerate(same)),
            "unpad_off_by_2_rows_max_px": min(float(np.abs(one[i][:-2] - many[i][2:]).max())
                                              for i in one)}
        # the held batch-4 engine's rate over a long in-memory stream
        n0 = len(eng.stats.batch_ms)
        stream = [infer.InferRequest(payload=k, inputs=reqs[k % len(reqs)].inputs)
                  for k in range(MAD_STREAM_REQUESTS)]
        rates = _engine_pairs_per_s(eng, stream, reps=2)
        stream_ms = sum(eng.stats.batch_ms[n0:]) / sum(eng.stats.batch_valid[n0:])
        slots = [r.inputs for r in reqs[:MAD_EVAL_BATCH]]
        eng = evaluate_mad.make_mad_engine(model, fusion, infer.InferOptions(
            batch=MAD_EVAL_BATCH))
        padder = BatchPadder([x[0].shape[:2] for x in slots], divis_by=eng.divis_by)
        arrays = tuple(padder.pad([x[k] for x in slots]) for k in range(len(slots[0])))
        key = eng._key(padder.bucket, arrays)
        replay = eng.graphs.run(key, eng.forward_fn,
                                tuple(torch.from_numpy(a) for a in arrays)).clone()
        eager = eng.forward_fn(*(torch.from_numpy(a).cuda() for a in arrays))
        torch.cuda.synchronize()
        res = {"phase": "mad_eval", "variant": name, "argv": flags,
               "entry": "raft_stereo_tpu_torch.evaluate_mad.main",
               "pairs": len(pairs), "shapes": [[540, 960], list(MAD_EVAL_PAIR1_SHAPE)],
               "bucket": list(padder.bucket), "engine_batch": MAD_EVAL_BATCH, **runs,
               "stream": {"requests": MAD_STREAM_REQUESTS, "pairs_per_s": rates,
                          "device_ms_per_pair": stream_ms,
                          "note": "held engine, decoded pairs in memory, after a warm-up "
                                  "stream"},
               "batched_vs_per_image_max_abs_px": diff, "tol_px": MAD_PER_IMAGE_TOL[name],
               "planted_faults": faults,
               "replay_equals_eager_bitwise": bool(torch.equal(replay, eager)),
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "card": smi_line()}
        emit(res)
        out.append(res)
        del model, eng, replay, eager
        torch.cuda.empty_cache()
        for mode, r in runs.items():
            m = r["metrics"]
            if (r["completed"] != len(pairs) or r["failed"] or m["things-nans"]
                    or not all(math.isfinite(m[k]) for k in ("things-epe", "things-d1"))):
                raise AssertionError(f"mad_eval {name} {mode}: {r}")
            if r["captures"] < 1 or r["replays"] < 1:
                raise AssertionError(f"mad_eval {name} {mode}: no captured replay: {r}")
        if diff > MAD_PER_IMAGE_TOL[name] or not res["replay_equals_eager_bitwise"]:
            raise AssertionError(f"mad_eval {name}: batched vs per-image {diff} px, replay "
                                 f"bitwise {res['replay_equals_eager_bitwise']}")
        if min(faults.values()) <= MAD_PER_IMAGE_TOL[name]:
            raise AssertionError(f"mad_eval {name}: MAD_PER_IMAGE_TOL passes a planted "
                                 f"fault {faults}")
    launches = _launches()
    emit({"phase": "mad_eval_launches", "launches": launches})
    _no_kernel_launched("mad_eval", launches)
    return {"phase": "mad_eval", "launches": launches, "variants": out}


def phase_mad_parity(tmp: Path):
    """MADNet2 and MADNet2Fusion on the card (fp32, TF32 off) against the
    same modules, same weights, on the CPU, at 384x1280 batch 2: every
    level within MAD_PARITY_RTOL of the CPU's largest value (+ ATOL)."""
    import copy

    import numpy as np
    import torch

    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2

    rng = np.random.RandomState(SEED)
    B, H, W = MAD_PARITY_SHAPE
    a, b = (torch.from_numpy((rng.rand(B, H, W, 3) * 255).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy((rng.rand(B, H, W, 1) * 40).astype(np.float32))
    _zero_launches()
    res = {"phase": "mad_parity", "shape": [B, H, W], "rtol": MAD_PARITY_RTOL,
           "atol": MAD_PARITY_ATOL, "card": smi_line()}
    with _fp32_checks(), torch.no_grad():
        for name, fusion in (("madnet2", False), ("fusion", True)):
            cpu = make_madnet2(fusion=fusion, seed=3)
            card = copy.deepcopy(cpu).cuda()
            inputs = (a, b, g) if fusion else (a, b)
            want = cpu(*inputs)
            got = card(*(x.cuda() for x in inputs))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                card(*(x.cuda() for x in inputs))
            torch.cuda.synchronize()
            errs = [float((x.cpu() - w).abs().max()) for x, w in zip(got, want)]
            scales = [float(w.abs().max()) for w in want]
            res[name] = {"max_abs_err_by_level": errs, "max_abs_cpu_by_level": scales,
                         "eager_ms_per_forward_card": 1e3 * (time.perf_counter() - t0) / 5}
            if any(e > MAD_PARITY_RTOL * s + MAD_PARITY_ATOL for e, s in zip(errs, scales)):
                raise AssertionError(f"mad_parity {name}: {res[name]}")
            del cpu, card
    res["launches"] = _launches()
    emit(res)
    _no_kernel_launched("mad_parity", res["launches"])
    return res


def _serve_adaptive(root: Path, name: str, argv, env=None) -> dict:
    """One ``serve_adaptive.main`` run in ``root`` (``env``: fault
    injectors, set for the run only): its summary, events, engine counts,
    wall time and adaptation step times."""
    import os

    import torch

    from raft_stereo_tpu_torch import serve_adaptive
    from raft_stereo_tpu_torch.runtime import faultinject

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    faultinject.reset()
    try:
        with _chdir(root):
            t0 = time.perf_counter()
            summary = serve_adaptive.main(["--name", name] + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            events = [json.loads(ln)["event"] for ln in
                      (Path("runs") / name / "events.jsonl").read_text().splitlines()]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faultinject.reset()
    srv = serve_adaptive.last_server()
    graphs = srv.engine.graphs
    hist = srv.proxy_history
    res = {"summary": {k: v for k, v in summary.items() if k != "quality"},
           "wall_s": wall, "pairs_per_s": summary["served"] / wall,
           "captures": graphs.captures, "replays": graphs.replays,
           "captures_by_key": sorted(graphs.captures_by_key.values()),
           "adapt_step_ms": [1e3 * s for s in srv.step_seconds],
           "proxy_by_opportunity": hist,
           "events": {e: events.count(e) for e in sorted(set(events))
                      if e.startswith(("adapt", "run_"))}}
    del srv, graphs
    return res


def phase_mad_adapt_serve(tmp: Path):
    """``serve_adaptive.main`` at KITTI 2015's frame size (375x1242, the
    384x1280 bucket) on a photometrically shifted synthetic stream, batch 2,
    a MAD step every 4 requests: adapting and ``--no_adapt`` over 64
    requests (proxy trends, steps and ms a step, pairs/s, and no capture
    after the first however many ``update_variables``); then
    ``RAFT_FI_ADAPT_NAN=1`` with ``--max_adapt_skips 1`` (a rollback),
    ``RAFT_FI_ADAPT_REGRESS=2`` with ``--regress_warmup 1 --max_rollbacks 1``
    (frozen) and one adapting run with ``--sched``."""
    import statistics

    root = tmp / "mad_serve"
    root.mkdir()
    n = str(MAD_SERVE_REQUESTS)
    _zero_launches()
    runs = {
        "adapting": _serve_adaptive(root, "adapt", MAD_SERVE_ARGV + ["--num_requests", n]),
        "no_adapt": _serve_adaptive(root, "frozen", MAD_SERVE_ARGV + [
            "--num_requests", n, "--no_adapt"]),
        "nan": _serve_adaptive(root, "nan", MAD_SERVE_ARGV + [
            "--num_requests", "8", "--max_adapt_skips", "1"], {"RAFT_FI_ADAPT_NAN": "1"}),
        "regress": _serve_adaptive(root, "regress", MAD_SERVE_ARGV + [
            "--num_requests", "12", "--regress_warmup", "1", "--max_rollbacks", "1"],
            {"RAFT_FI_ADAPT_REGRESS": "2"}),
        "sched": _serve_adaptive(root, "sched", MAD_SERVE_ARGV + [
            "--num_requests", "16", "--sched"]),
    }
    launches = _launches()
    steps_ms = runs["adapting"]["adapt_step_ms"]
    res = {"phase": "mad_adapt_serve", "entry": "raft_stereo_tpu_torch.serve_adaptive.main",
           "argv": MAD_SERVE_ARGV, "bucket": [384, 1280], "runs": runs,
           "adapt_step_ms_median": statistics.median(steps_ms) if steps_ms else None,
           "launches": launches, "card": smi_line()}
    emit(res)
    _no_kernel_launched("mad_adapt_serve", launches)
    opportunities = MAD_SERVE_REQUESTS // 4
    for name, r in runs.items():
        s = r["summary"]
        want = {"adapting": MAD_SERVE_REQUESTS, "no_adapt": MAD_SERVE_REQUESTS, "nan": 8,
                "regress": 12, "sched": 16}[name]
        if s["served"] != want or s["failed"]:
            raise AssertionError(f"mad_adapt_serve {name}: served {s}")
        # one key (the 384x1280 bucket at batch 2), captured once, however
        # many pushes followed
        if r["captures"] != 1 or r["captures_by_key"] != [1]:
            raise AssertionError(f"mad_adapt_serve {name}: captures {r['captures_by_key']}")
    ad, fr = runs["adapting"]["summary"], runs["no_adapt"]["summary"]
    # every opportunity observes a proxy: a step's, a regressed step's, or
    # (frozen after natural regressions) a frozen evaluation's
    if (ad["adapt_steps"] < 1 or ad["adapt_skips"]
            or len(runs["adapting"]["proxy_by_opportunity"]) != opportunities):
        raise AssertionError(f"mad_adapt_serve adapting: {ad}")
    if fr["adapt_steps"] or fr["snapshots"] or len(runs["no_adapt"]["proxy_by_opportunity"]) \
            != opportunities:
        raise AssertionError(f"mad_adapt_serve no_adapt: {fr}")
    nan = runs["nan"]
    if nan["summary"]["adapt_skips"] < 1 or nan["summary"]["rollbacks"] < 1 \
            or not nan["events"].get("adapt_rollback"):
        raise AssertionError(f"mad_adapt_serve nan: {nan['summary']} {nan['events']}")
    reg = runs["regress"]
    if not reg["summary"]["frozen"] or not reg["events"].get("adapt_frozen"):
        raise AssertionError(f"mad_adapt_serve regress: {reg['summary']} {reg['events']}")
    if runs["sched"]["summary"]["adapt_steps"] < 1 or \
            len(runs["sched"]["proxy_by_opportunity"]) != 4:
        raise AssertionError(f"mad_adapt_serve sched: {runs['sched']['summary']}")
    return res


def phase_mad_train(tmp: Path):
    """``train_mad.main`` at the JAX defaults (MADNet2, batch 6, 384x768
    crops, Adam 1e-4) for 6 steps on a synthetic FlyingThings3D TRAIN tree
    (12 pairs at 540x960): s/step and peak memory; then ``--adapt mad``
    from its final checkpoint over 8 full frames in order."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import train_mad
    from raft_stereo_tpu_torch.runtime.checkpoint import verify_checkpoint
    from raft_stereo_tpu_torch.utils import metrics

    root = tmp / "mad_train"
    _write_things_tree(root, n=MAD_TRAIN_PAIRS)
    argv = ["--name", "madnet2", "--num_steps", str(MAD_TRAIN_STEPS),
            "--validation_frequency", "1000000"]
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    saved_freq = metrics.SUM_FREQ
    metrics.SUM_FREQ = 1  # a metrics row every step: the loss per step
    with _chdir(root), contextlib.ExitStack() as stack:
        stack.callback(setattr, metrics, "SUM_FREQ", saved_freq)
        t0 = time.perf_counter()
        result = train_mad.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        final = str(Path(result.path).resolve())
        verified = verify_checkpoint(final)
        rows = [json.loads(ln) for ln in
                (Path("runs") / "madnet2" / "metrics.jsonl").read_text().splitlines()]
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        adapted = train_mad.main(["--name", "madnet2", "--adapt", "mad", "--num_steps",
                                  str(MAD_ADAPT_FRAMES), "--restore_ckpt", final])
        torch.cuda.synchronize()
        adapt_wall = time.perf_counter() - t1
        adapt_peak = torch.cuda.max_memory_allocated()
    run = train_mad.last_adapt()
    launches = _launches()
    step_s = result.timings.step_seconds
    median = statistics.median(step_s[2:]) if len(step_s) > 2 else None
    res = {"phase": "mad_train", "entry": "raft_stereo_tpu_torch.train_mad.main",
           "argv": argv, "config": "MADNet2 fp32, batch 6, 384x768, Adam 1e-4, wd 1e-5",
           "steps": result.total_steps, "step_seconds": step_s,
           "s_per_step_median_steps_3_6": median,
           "pairs_per_s": 6 / median if median else None,
           "loop_means": result.timings.means(), "wall_s_with_setup": wall,
           "max_memory_allocated_bytes": peak, "final_verified": verified,
           "losses": [r.get("live_loss") for r in rows if "live_loss" in r],
           "adapt": {"frames": MAD_ADAPT_FRAMES, "shape": [540, 960], "bucket": [640, 1024],
                     "losses": run["losses"], "distribution": run["distribution"],
                     "wall_s": adapt_wall, "ms_per_frame": 1e3 * adapt_wall / MAD_ADAPT_FRAMES,
                     "max_memory_allocated_bytes": adapt_peak, "path": str(adapted)},
           "launches": launches, "card": smi_line()}
    emit(res)
    del result
    torch.cuda.empty_cache()
    _no_kernel_launched("mad_train", launches)
    if res["steps"] != MAD_TRAIN_STEPS or not verified or len(res["losses"]) != \
            MAD_TRAIN_STEPS or not all(np.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"mad_train: {res}")
    if len(run["losses"]) != MAD_ADAPT_FRAMES or not all(np.isfinite(run["losses"])):
        raise AssertionError(f"mad_train adapt: {run}")
    return res


# --------------------------------------------------- the serving composition

# tier_path and iter_tiers_path serve the slice-1 preset (32 iterations),
# cascade_path the realtime preset (7), on the synthetic ETH3D tree
# (ETH3D_SCENES: two buckets) at batch 4.
COMPOSITION_BATCH = 4
ITER_TIERS = (7, 32)
# iter_tiers_path's in-memory stream: the tree's pairs twice, every other
# request with a deadline under IterTierPolicy's 1 s cutoff (-> iters7)
ITER_TIERS_STREAM = 12
# cascade_path's thresholds: accept all, escalate all (a photometric
# confidence is at most 1, and only an exact reconstruction reaches it),
# and the CLI's default
CASCADE_THRESHOLDS = (("accept_all", 0.0), ("escalate_all", 1.0), ("default", 0.85))
# pairs/s of the cascade and of each tier alone over this many in-memory
# requests (the decoded pairs repeated), after a warm-up stream
CASCADE_STREAM_REQUESTS = 256
# controller_path: serve_adaptive --cascade at KITTI 2015's frame size,
# batch 2, both tiers behind schedulers (the depth sensor), a fast tier
# adapting every 32 requests, a bar of 0.99 that escalates nearly every pair
# (the cascade_bar rung lowers it to 0.69). The burst is one chunk of
# CTRL_BURST requests at once: the queues pass --controller_depth_high and
# the requests queued behind the captures and the earlier batches finish
# past the SLO's 250 ms over several ticks. Then no arrival until the
# ladder is back at rung 0 (at most CTRL_SETTLE_S), and a calm tail of
# CTRL_TAIL requests, one batch a tier, inside the SLO (on an H100 a pair of
# the 8-iteration quality tier takes ~45 device ms, PERF §6). The quality
# tier captures its graph before any traffic: when the bar drops before the
# burst's first decision, the tail's escalation would otherwise be the
# first, and its capture a real breach of the SLO in the tail.
CTRL_ARGV = ["--source", "synthetic", "--synthetic_size", "375", "1242", "--infer_batch", "2",
             "--adapt_every", "32", "--cascade", "--cascade_threshold", "0.99",
             "--quality_iters", "8", "--sched",
             "--max_pending", "64", "--controller", "--controller_interval", "0.1",
             "--controller_dwell", "1.0", "--controller_depth_high", "4",
             "--slo_p95_ms", "250", "--debug_port", "0"]
CTRL_BURST = 32
CTRL_TAIL = 2
CTRL_SETTLE_S = 30.0
CTRL_ENDPOINTS = ("/healthz", "/debug/queues", "/debug/snapshots", "/debug/stacks",
                  "/debug/quality")


@contextlib.contextmanager
def _recorded_predictions():
    """Record what ``evaluate``'s validators get from the engine path: each
    pair's disparity by dataset index, and the serving object (the engine,
    or the tiered stand-in with its ``tier_set``)."""
    from raft_stereo_tpu_torch import evaluate

    inner = evaluate._engine_predictions
    rec = {"preds": {}, "serving": None}

    def recorded(model, iters, ds, infer, drain=None):
        serving, results = inner(model, iters, ds, infer, drain=drain)
        rec["serving"] = serving

        def gen():
            for i, pred, gt in results:
                rec["preds"][i] = pred.copy()
                yield i, pred, gt

        return serving, gen()

    evaluate._engine_predictions = recorded
    try:
        yield rec
    finally:
        evaluate._engine_predictions = inner


def _tier_engines(serving) -> dict:
    """The engines of a plain engine, a ``TierSet`` or a tiered stand-in."""
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine
    from raft_stereo_tpu_torch.runtime.tiers import TierSet

    if isinstance(serving, InferenceEngine):
        return {"untiered": serving}
    return dict((serving if isinstance(serving, TierSet) else serving.tier_set).engines)


def _replayed(serving) -> dict:
    """Launches at capture x replays, summed over the serving's engines."""
    total = {}
    for eng in _tier_engines(serving).values():
        for k, n in eng.graphs.replayed_launches.items():
            total[k] = total.get(k, 0) + n
    return total


def _tiers_report(serving, n0=None) -> dict:
    """Per tier: device ms a served pair (CUDA events, from the batch's
    input copy to its output copy, over the batches after ``n0[tier]``),
    captures and each key's captures, replays."""
    out = {}
    for name, eng in _tier_engines(serving).items():
        k0 = (n0 or {}).get(name, 0)
        ms, valid = eng.stats.batch_ms[k0:], eng.stats.batch_valid[k0:]
        out[name] = {"device_ms_per_pair": sum(ms) / sum(valid) if valid else None,
                     "batches": len(ms), "captures": eng.graphs.captures,
                     "captures_by_key": sorted(eng.graphs.captures_by_key.values()),
                     "replays": eng.graphs.replays}
    return out


def _one_capture_a_key(phase: str, report: dict) -> None:
    for name, r in report.items():
        if any(n != 1 for n in r["captures_by_key"]):
            raise AssertionError(f"{phase}: tier {name} captured a key twice: {report}")


def _preds_equal(got: dict, want: dict) -> dict:
    import numpy as np

    same = [k for k in want if k in got and got[k].shape == want[k].shape
            and np.array_equal(got[k], want[k])]
    return {"compared": len(want), "bitwise_equal": len(same),
            "keys_match": sorted(got) == sorted(want)}


def _eth3d_pairs(root: Path) -> list:
    from raft_stereo_tpu_torch.data import datasets

    with _chdir(root):
        ds = datasets.ETH3D(aug_params=None)
        return [ds[i][:2] for i in range(len(ds))]


def phase_tier_path(tmp: Path):
    """``evaluate --dataset eth3d --preset raftstereo-middlebury`` (32
    iterations, batch 4) untiered and with ``--tier quality``: the same
    metrics and each pair's disparity bitwise (the path: counts set to 0
    before the tiered run, K1's launches its graphs' replays); then ``--tier
    fast`` (the MADNet2 tier, bf16 as the preset): K1-K3 launch 0 times."""
    from raft_stereo_tpu_torch import evaluate

    t_phase = time.perf_counter()
    root = _eth3d_tree(tmp)
    argv = ["--dataset", "eth3d", "--preset", "raftstereo-middlebury", "--valid_iters", "32",
            "--infer_batch", str(COMPOSITION_BATCH)]
    with _chdir(root):
        with _launches_kept(), _recorded_predictions() as plain:
            plain_metrics = evaluate.main(argv)
        _zero_launches()
        with _recorded_predictions() as tiered:
            tier_metrics = evaluate.main(argv + ["--tier", "quality"])
        wrapper = _launches()
        launches = _replayed(tiered["serving"])
        with _launches_kept():
            before = _launches()
            with _recorded_predictions() as fast:
                fast_metrics = evaluate.main(argv + ["--tier", "fast"])
            fast_wrapper = {k: n - before[k] for k, n in _launches().items()}
    fast_replayed = _replayed(fast["serving"])
    cmp = _preds_equal(tiered["preds"], plain["preds"])
    reports = {"untiered": _tiers_report(plain["serving"]),
               "tier_quality": _tiers_report(tiered["serving"]),
               "tier_fast": _tiers_report(fast["serving"])}
    res = {"phase": "tier_path", "entry": "raft_stereo_tpu_torch.evaluate.main --tier",
           "argv": argv, "untiered": plain_metrics, "tier_quality": tier_metrics,
           "tier_fast": fast_metrics, "metrics_equal": tier_metrics == plain_metrics,
           "quality_vs_untiered": cmp, "tiers": reports, "launches": launches,
           "launches_counted_as": "launches at capture x replays",
           "wrapper_launches_warmup_and_capture": wrapper,
           "fast_launches": {"wrapper": fast_wrapper, "replayed": fast_replayed},
           "seconds": time.perf_counter() - t_phase, "card": smi_line()}
    emit(res)
    n = len(plain["preds"])
    if not res["metrics_equal"] or cmp["bitwise_equal"] != n or not cmp["keys_match"]:
        raise AssertionError(f"tier_path: --tier quality against untiered: {res}")
    if not all(math.isfinite(v) for v in fast_metrics.values()) or len(fast["preds"]) != n:
        raise AssertionError(f"tier_path: --tier fast {fast_metrics}")
    _no_kernel_launched("tier_path --tier fast", fast_wrapper)
    _no_kernel_launched("tier_path --tier fast", fast_replayed)
    for name in ("tier_quality", "tier_fast"):
        _one_capture_a_key(f"tier_path {name}", reports[name])
    return res


def phase_cascade_path(tmp: Path):
    """``evaluate --preset raftstereo-realtime --cascade`` (7 iterations,
    batch 4) at three thresholds, against ``--tier fast`` and ``--tier
    quality`` run alone (same preset, same batch): accept-all outputs
    bitwise the fast tier's, escalate-all bitwise the quality tier's, the
    default's each bitwise one of the two with accepted + escalated = pairs
    (the decisions from the cascade_accept / cascade_escalate events). The
    path: the three runs, counts set to 0 before and read after. Then the
    cascade, the fast tier and the quality tier held in this process over
    CASCADE_STREAM_REQUESTS in-memory requests each, after a warm-up
    stream, in turns: pairs/s, device ms a pair per tier, the share
    escalated (seeded random weights: recorded, not bounded)."""
    import numpy as np
    import torch

    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.runtime.infer import InferOptions, InferRequest

    t_phase = time.perf_counter()
    root = _eth3d_tree(tmp)
    argv = ["--dataset", "eth3d", "--preset", "raftstereo-realtime", "--valid_iters", "7",
            "--infer_batch", str(COMPOSITION_BATCH)]
    with _chdir(root):
        with _launches_kept():
            with _recorded_predictions() as fast_alone:
                evaluate.main(argv + ["--tier", "fast"])
            with _recorded_predictions() as quality_alone:
                evaluate.main(argv + ["--tier", "quality"])
        _zero_launches()
        runs, launches = {}, {}
        for name, threshold in CASCADE_THRESHOLDS:
            tel_dir = tmp / "cascade_tel" / name
            with _recorded_predictions() as rec:
                metrics = evaluate.main(argv + ["--cascade", "--cascade_threshold",
                                                str(threshold), "--telemetry_dir", str(tel_dir)])
            events = [e["event"] for e in _events_of(tel_dir)]
            for k, n in _replayed(rec["serving"]).items():
                launches[k] = launches.get(k, 0) + n
            preds = rec["preds"]
            runs[name] = {
                "threshold": threshold, "metrics": metrics,
                "accepted": events.count("cascade_accept"),
                "escalated": events.count("cascade_escalate"),
                "vs_fast_alone": _preds_equal(preds, fast_alone["preds"]),
                "vs_quality_alone": _preds_equal(preds, quality_alone["preds"]),
                "each_one_of_the_two": all(
                    np.array_equal(p, fast_alone["preds"][k])
                    or np.array_equal(p, quality_alone["preds"][k]) for k, p in preds.items()),
                "tiers": _tiers_report(rec["serving"])}
        wrapper = _launches()
    n_pairs = len(fast_alone["preds"])

    # the long stream, in this process
    pairs = _eth3d_pairs(root)
    model = evaluate.load_model(PRESETS["raftstereo-realtime"], seed=0)
    stream = [InferRequest(payload=k, inputs=pairs[k % len(pairs)])
              for k in range(CASCADE_STREAM_REQUESTS)]
    warm = [InferRequest(payload=k, inputs=pairs[k % len(pairs)]) for k in range(4 * len(pairs))]
    with _launches_kept():
        servings = {kind: evaluate.make_serving(model, 7, InferOptions(
            batch=COMPOSITION_BATCH, **opts))
            for kind, opts in (("cascade", {"cascade": True}), ("fast", {"tier": "fast"}),
                               ("quality", {"tier": "quality"}))}
        for _, fn in servings.values():
            list(fn(iter(warm)))
        cascade = servings["cascade"][1].__self__  # the CascadeServer
        before = cascade.summary()
        rates, device = {k: [] for k in servings}, {k: [] for k in servings}
        for kind in ("cascade", "fast", "quality", "quality", "fast", "cascade"):
            serving, fn = servings[kind]
            n0 = {t: len(e.stats.batch_ms) for t, e in serving.tier_set.engines.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = sum(r.ok for r in fn(iter(stream)))
            torch.cuda.synchronize()
            rates[kind].append(done / (time.perf_counter() - t0))
            device[kind].append({t: r["device_ms_per_pair"] for t, r in
                                 _tiers_report(serving, n0).items() if r["batches"]})
        after = cascade.summary()
        stream_tiers = {kind: _tiers_report(s) for kind, (s, _) in servings.items()}
    esc = after["escalated"] - before["escalated"]
    acc = after["accepted"] - before["accepted"]
    res = {"phase": "cascade_path", "entry": "raft_stereo_tpu_torch.evaluate.main --cascade",
           "argv": argv, "pairs": n_pairs, "runs": runs, "launches": launches,
           "launches_counted_as": "launches at capture x replays",
           "wrapper_launches_warmup_and_capture": wrapper,
           "stream": {"requests": CASCADE_STREAM_REQUESTS, "pairs_per_s": rates,
                      "device_ms_per_pair": device, "escalated_share": esc / (esc + acc),
                      "threshold": after["threshold"], "tiers": stream_tiers,
                      "order": "cascade, fast, quality, quality, fast, cascade"},
           "seconds": time.perf_counter() - t_phase, "card": smi_line()}
    emit(res)
    del servings, cascade, model
    torch.cuda.empty_cache()
    a, e, d = runs["accept_all"], runs["escalate_all"], runs["default"]
    if (a["accepted"], a["escalated"]) != (n_pairs, 0) or \
            a["vs_fast_alone"]["bitwise_equal"] != n_pairs:
        raise AssertionError(f"cascade_path accept_all: {a}")
    if (e["accepted"], e["escalated"]) != (0, n_pairs) or \
            e["vs_quality_alone"]["bitwise_equal"] != n_pairs:
        raise AssertionError(f"cascade_path escalate_all: {e}")
    if d["accepted"] + d["escalated"] != n_pairs or not d["each_one_of_the_two"] or \
            d["vs_quality_alone"]["bitwise_equal"] < d["escalated"]:
        raise AssertionError(f"cascade_path default: {d}")
    for r in runs.values():
        _one_capture_a_key("cascade_path", r["tiers"])
    for kind, rep in stream_tiers.items():
        _one_capture_a_key(f"cascade_path stream {kind}", rep)
    return res


def phase_iter_tiers_path(tmp: Path, untiered_metrics=None):
    """``evaluate --preset raftstereo-middlebury --adaptive_iters --iter_tiers
    7,32`` on the ETH3D tree (every request by default to iters32: the same
    metrics as the untiered run of tier_path), then the same assembly
    (``evaluate.make_serving``) over an in-memory stream that gives every
    other request a 0.5 s deadline: each request served by the tier
    IterTierPolicy names (its tier_dispatch event), and its output bitwise
    that tier's plain engine's (the captured adaptive forward at that count,
    fed that tier's requests in order). The path: both runs, counts set to
    0 before and read after."""
    import numpy as np

    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.runtime import telemetry
    from raft_stereo_tpu_torch.runtime.infer import InferOptions, InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest
    from raft_stereo_tpu_torch.runtime.tiers import IterTierPolicy, iter_tier_name

    t_phase = time.perf_counter()
    root = _eth3d_tree(tmp)
    argv = ["--dataset", "eth3d", "--preset", "raftstereo-middlebury", "--valid_iters", "32",
            "--infer_batch", str(COMPOSITION_BATCH), "--adaptive_iters", "--iter_tiers",
            ",".join(map(str, ITER_TIERS))]
    _zero_launches()
    with _chdir(root), _recorded_predictions() as rec:
        cli_metrics = evaluate.main(argv)
    cli_tiers = _tiers_report(rec["serving"])
    launches = _replayed(rec["serving"])

    pairs = _eth3d_pairs(root)
    model = evaluate.load_model(PRESETS["raftstereo-middlebury"], seed=0)
    serving, stream_fn = evaluate.make_serving(model, ITER_TIERS[-1], InferOptions(
        batch=COMPOSITION_BATCH, adaptive_iters=True, iter_tiers=ITER_TIERS))
    items = [SchedRequest(InferRequest(payload=k, inputs=pairs[k % len(pairs)]),
                          deadline_s=0.5 if k % 2 else None) for k in range(ITER_TIERS_STREAM)]
    want_tier = {it.request.payload: IterTierPolicy(ITER_TIERS).select(it)[0] for it in items}
    tel_dir = tmp / "iter_tiers_tel"
    tel = telemetry.install(telemetry.Telemetry(str(tel_dir)))
    try:
        got = {r.payload: r for r in stream_fn(iter(items))}
    finally:
        telemetry.uninstall(tel)
    for k, n in _replayed(serving).items():
        launches[k] = launches.get(k, 0) + n
    wrapper = _launches()
    stream_tiers = _tiers_report(serving)
    routed = {e["trace_id"]: e["tier"] for e in _events_of(tel_dir)
              if e["event"] == "tier_dispatch"}
    served_by = {k: routed.get(r.trace_id) for k, r in got.items()}
    with _launches_kept():
        plain = {}
        for it in ITER_TIERS:
            engine, fn = evaluate.make_serving(model, it, InferOptions(
                batch=COMPOSITION_BATCH, adaptive_iters=True))
            mine = [InferRequest(payload=k, inputs=pairs[k % len(pairs)])
                    for k in sorted(got) if want_tier[k] == iter_tier_name(it)]
            plain.update({r.payload: r.output for r in fn(iter(mine))})
    cmp = _preds_equal({k: r.output for k, r in got.items()}, plain)
    res = {"phase": "iter_tiers_path",
           "entry": "raft_stereo_tpu_torch.evaluate.main --adaptive_iters --iter_tiers",
           "argv": argv, "metrics": cli_metrics,
           "metrics_equal_untiered": (None if untiered_metrics is None
                                      else cli_metrics == untiered_metrics),
           "cli_tiers": cli_tiers, "stream": {
               "requests": ITER_TIERS_STREAM, "deadline_s_every_other": 0.5,
               "served_by": {str(k): v for k, v in sorted(served_by.items())},
               "policy": {str(k): v for k, v in sorted(want_tier.items())},
               "vs_plain_engines": cmp, "tiers": stream_tiers},
           "launches": launches, "launches_counted_as": "launches at capture x replays",
           "wrapper_launches_warmup_and_capture": wrapper,
           "seconds": time.perf_counter() - t_phase, "card": smi_line()}
    emit(res)
    del serving, stream_fn, model
    if untiered_metrics is not None and not res["metrics_equal_untiered"]:
        raise AssertionError(f"iter_tiers_path: CLI metrics {cli_metrics} vs untiered "
                             f"{untiered_metrics}")
    if served_by != want_tier or set(served_by.values()) != {iter_tier_name(t)
                                                             for t in ITER_TIERS}:
        raise AssertionError(f"iter_tiers_path: routing {served_by} vs policy {want_tier}")
    if not all(r.ok for r in got.values()) or cmp["bitwise_equal"] != ITER_TIERS_STREAM:
        raise AssertionError(f"iter_tiers_path: against the plain engines {cmp}")
    _one_capture_a_key("iter_tiers_path", cli_tiers)
    _one_capture_a_key("iter_tiers_path", stream_tiers)
    if not np.isfinite(list(cli_metrics.values())).all():
        raise AssertionError(f"iter_tiers_path: {cli_metrics}")
    return res


def phase_controller_path(tmp: Path):
    """``serve_adaptive --cascade --controller --slo_p95_ms --telemetry_dir
    --debug_port 0`` at KITTI 2015's 375x1242 (CTRL_ARGV): a burst of
    CTRL_BURST requests, no arrival until the controller has promoted back
    to rung 0, a calm tail of CTRL_TAIL. The ctrl_degrade events climb the
    ladder in order, every ctrl_promote follows the dwell and walks it back
    down, each value inside the bounds its event declares; every request
    resolves once; a thread GETs the debug endpoints throughout and, in the
    pause, each answers 200 and names the controller and the tiers. The
    quality tier is the default raftstereo (the reg lookup, no kernel), so
    K1-K3 launch 0 times; it captures its graph on a warm-up batch before
    any traffic, so the calm tail replays it."""
    import io
    import re
    import statistics
    import threading
    import urllib.request

    import torch

    from raft_stereo_tpu_torch import serve_adaptive
    from raft_stereo_tpu_torch.runtime import controller
    from raft_stereo_tpu_torch.runtime.infer import InferRequest

    t_phase = time.perf_counter()
    root = tmp / "ctrl"
    root.mkdir()
    tel_dir = root / "tel"
    out = io.StringIO()
    state = {"port": None}
    yielded, resolved, probes, tick_ms = [], [], [], []
    stop = threading.Event()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{state['port']}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())

    def prober():
        while not stop.is_set():
            for path in CTRL_ENDPOINTS:
                try:
                    status, doc = get(path)
                except OSError as e:  # the serve ended under the probe, or an error status
                    if stop.is_set():
                        return
                    probes.append((path, getattr(e, "code", repr(e)), None))
                    continue
                serving = None
                if path == "/debug/queues":
                    serving = any(v.get("serving") for k, v in doc.items()
                                  if k.startswith("cascade"))
                probes.append((path, status, serving))
            stop.wait(0.2)

    def ctrl_snapshot():
        snaps = get("/debug/snapshots")[1]
        return next(v for k, v in snaps.items() if k.split("#")[0] == "controller")

    inner_stream = serve_adaptive.request_stream

    def warm_quality(args):
        """One batch straight through the quality tier's engine, on this
        (the consumer's) thread before the first chunk is served: its
        graph is captured, and its results observed, before any traffic.
        Its wall ms is what a first escalation would wait on a first start
        with an empty graph store (``aot_path`` measures a prewarmed one)."""
        quality = serve_adaptive.last_cascade().tiers.engine("quality")
        pair = serve_adaptive.synthetic_frame(SEED, *args.synthetic_size)
        warm = [InferRequest(payload=f"warm{k}", inputs=pair) for k in range(args.infer_batch)]
        t0 = time.perf_counter()
        if not all(r.ok for r in quality.stream(iter(warm))):
            raise AssertionError("controller_path: the quality tier's warm-up failed")
        state["quality_cold_ms"] = 1e3 * (time.perf_counter() - t0)

    def bursty(args):
        for i, req in enumerate(inner_stream(args)):
            if i == 0:
                warm_quality(args)
                state["port"] = int(re.search(
                    r"introspection server on http://127\.0\.0\.1:(\d+)",
                    out.getvalue()).group(1))
                threading.Thread(target=prober, name="ctrl-prober", daemon=True).start()
            if i == CTRL_BURST:
                t0 = time.monotonic()
                while time.monotonic() - t0 < CTRL_SETTLE_S:
                    snap = ctrl_snapshot()
                    if snap["degrades"] >= 1 and snap["rung"] == 0:
                        break
                    time.sleep(0.1)
                state["calm_s"] = time.monotonic() - t0
                state["pause"] = {p: get(p) for p in CTRL_ENDPOINTS}
            yielded.append(req.payload)
            yield req

    class Recording(serve_adaptive.AdaptiveServer):
        def serve(self, requests):
            for r in super().serve(requests):
                resolved.append((r.payload, r.ok))
                yield r
            stop.set()  # the probes end before the debug server does

    tick = controller.OverloadController._tick

    def timed_tick(self):
        t0 = time.perf_counter()
        tick(self)
        tick_ms.append(1e3 * (time.perf_counter() - t0))

    serve_adaptive.request_stream = bursty
    serve_adaptive.AdaptiveServer = Recording
    controller.OverloadController._tick = timed_tick
    argv = ["--name", "ctrl"] + CTRL_ARGV + [
        "--num_requests", str(CTRL_BURST + CTRL_TAIL), "--telemetry_dir", str(tel_dir)]
    _zero_launches()
    try:
        with _chdir(root), contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            summary = serve_adaptive.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        stop.set()
        serve_adaptive.request_stream = inner_stream
        serve_adaptive.AdaptiveServer = Recording.__mro__[1]
        controller.OverloadController._tick = tick
    launches = _launches()
    cascade = serve_adaptive.last_cascade()
    tiers = _tiers_report(cascade.tiers)
    events = _events_of(tel_dir)
    moves = [e for e in events if e["event"] in ("ctrl_degrade", "ctrl_promote")]
    pause = state.get("pause") or {}
    snap = next(v for k, v in pause["/debug/snapshots"][1].items()
                if k.split("#")[0] == "controller") if pause else {}
    ladder = snap.get("ladder", [])
    walk, pos, last_t = [], 0, None
    for e in moves:
        up = e["event"] == "ctrl_degrade"
        knob = ladder[pos]["knob"] if up else ladder[pos - 1]["knob"]
        walk.append({"event": e["event"], "from": e["from_rung"], "to": e["rung"],
                     "knob": e["knob"], "value": e["value"], "lo": e["lo"], "hi": e["hi"],
                     "in_order": e["from_rung"] == pos and e["rung"] == pos + (1 if up else -1)
                     and e["knob"] == knob, "in_bounds": e["lo"] <= e["value"] <= e["hi"],
                     "after_dwell": up or e["t_mono"] - last_t >= e["dwell_s"]})
        pos, last_t = e["rung"], e["t_mono"]
    kinds = [w["event"] for w in walk]
    names = {p: sorted(k.split("#")[0] for k in doc) for p, (_, doc) in pause.items()
             if p in ("/healthz", "/debug/queues", "/debug/snapshots")}
    if pause:
        names["/healthz"] = pause["/healthz"][1]["providers"]
        names["/debug/stacks"] = sorted({t["name"] for t in pause["/debug/stacks"][1]["threads"]})
        names["/debug/quality"] = sorted(pause["/debug/quality"][1]["tiers"])
    res = {"phase": "controller_path",
           "entry": "raft_stereo_tpu_torch.serve_adaptive.main --cascade --controller",
           "argv": argv, "burst": CTRL_BURST, "tail": CTRL_TAIL, "wall_s": wall,
           "calm_s": state.get("calm_s"),
           # the quality tier's first batch, its capture included: a first
           # escalation's wait were it not warmed (the SLO is 250 ms p95)
           "quality_cold_ms": state.get("quality_cold_ms"),
           "summary": {k: v for k, v in summary.items() if k != "quality"},
           "ladder": ladder, "moves": walk,
           "ticks": len(tick_ms), "tick_ms": {
               "median": statistics.median(tick_ms) if tick_ms else None,
               "max": max(tick_ms, default=None)},
           "probes": {"n": len(probes), "non_200": [p for p in probes if p[1] != 200],
                      "while_cascade_serving": sum(1 for p in probes if p[2])},
           "pause_statuses": {p: s for p, (s, _) in pause.items()}, "pause_names": names,
           "requests": {"yielded": len(yielded), "resolved": len(resolved),
                        "failed": sum(1 for _, ok in resolved if not ok)},
           "tiers": tiers, "escalated_share": (
               summary["cascade"]["escalated"] / max(1, summary["cascade"]["escalated"]
                                                      + summary["cascade"]["accepted"])),
           "launches": launches, "seconds": time.perf_counter() - t_phase,
           "card": smi_line()}
    emit(res)
    del cascade
    torch.cuda.empty_cache()
    _no_kernel_launched("controller_path", launches)
    if sorted(p for p, _ in resolved) != sorted(yielded) or \
            len({p for p, _ in resolved}) != len(resolved) or \
            len(yielded) != CTRL_BURST + CTRL_TAIL or res["requests"]["failed"]:
        raise AssertionError(f"controller_path: requests {res['requests']}")
    n_up = kinds.count("ctrl_degrade")
    if not n_up or kinds != ["ctrl_degrade"] * n_up + ["ctrl_promote"] * n_up or \
            not all(w["in_order"] and w["in_bounds"] and w["after_dwell"] for w in walk):
        raise AssertionError(f"controller_path: the ladder's walk {walk} over {ladder}")
    if set(res["pause_statuses"].values()) != {200} or res["probes"]["non_200"] or \
            not res["probes"]["n"]:
        raise AssertionError(f"controller_path: debug endpoints {res['probes']}, "
                             f"{res['pause_statuses']}")
    want_names = {"/healthz": {"controller", "cascade", "engine:fast", "engine:quality"},
                  "/debug/queues": {"cascade", "scheduler:fast", "scheduler:quality"},
                  "/debug/snapshots": {"controller", "cascade", "engine:fast",
                                       "engine:quality"},
                  "/debug/stacks": {"overload-ctrl", "debug-server"},
                  "/debug/quality": {"fast", "quality"}}
    if any(not want <= {n.split("#")[0] for n in names.get(p, [])}
           for p, want in want_names.items()):
        raise AssertionError(f"controller_path: the endpoints name {names}")
    _one_capture_a_key("controller_path", tiers)
    return res


# ------------------------------------------------------------------ the fleet

FLEET_HW = (375, 1242)  # KITTI 2015, as mad_adapt_serve
FLEET_BATCH = 2
FLEET_REQUESTS = 96
FLEET_KILL_AFTER = 32  # about a third of the results, then SIGKILL host 0
FLEET_RESTART_AFTER = 24
FLEET_RESTART_REQUESTS = 48
FLEET_VIDEO_REQUESTS = 24
FLEET_MAX_WAIT_S = 0.2
FLEET_CLI_TIMEOUT_S = 240.0
FLEET_DEVICE = "cuda"
FLEET_CLI = ["-m", "raft_stereo_tpu_torch.serve_fleet"]
FLEET_CLI_ARGV = ["--model", "madnet2", "--n_hosts", "2", "--synthetic_size",
                  str(FLEET_HW[0]), str(FLEET_HW[1]), "--infer_batch", str(FLEET_BATCH),
                  "--sched_max_wait", str(FLEET_MAX_WAIT_S)]


def _fleet_pairs(n: int):
    """``n`` in-memory requests at FLEET_HW, made from SEED (the serve
    times the fleet, not a synthetic frame's ~0.2 s of host work)."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest

    rng = np.random.default_rng(SEED)
    shape = (*FLEET_HW, 3)
    return [InferRequest(payload=i, inputs=tuple(
        (rng.random(shape, dtype=np.float32) * 255.0) for _ in range(2))) for i in range(n)]


def _compute_apps() -> dict:
    """``nvidia-smi``'s compute processes, (pid, used MiB) each, and the
    card's memory in use (MiB). In a container the pids may be another
    namespace's: the entries still count the processes holding a context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    apps = []
    for line in out.strip().splitlines():
        pid, mib = (x.strip() for x in line.split(","))
        apps.append((int(pid), float(mib)))
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return {"apps": apps, "used_mib": float(used.strip().splitlines()[0])}


def _worker_captures(workdir: Path, n_hosts: int) -> dict:
    """Each worker's ``bucket_compile`` events (one a warm-up and capture),
    by engine key, and their ms, from its own telemetry directory."""
    out = {}
    for i in range(n_hosts):
        evs = [e for e in _events_of(workdir / f"host{i}") if e["event"] == "bucket_compile"]
        keys = {}
        for e in evs:
            k = f"{e['bucket'][0]}x{e['bucket'][1]}/b{e['batch']}"
            keys[k] = keys.get(k, 0) + 1
        out[str(i)] = {"by_key": keys, "compile_ms": [e["compile_ms"] for e in evs]}
    return out


def _fleet_hosts(snap: dict) -> dict:
    return {h: {k: v[k] for k in ("pid", "state", "incarnation", "dispatched", "resolved",
                                  "spawn_s", "ready_s")} for h, v in snap["hosts"].items()}


def _fleet_serve(router, reqs, kill_after=None):
    """Serve ``reqs`` once, SIGKILLing host 0 after ``kill_after`` results;
    the results by payload, the wall seconds, and how often each payload
    resolved."""
    import os
    import signal

    seen, results = {}, {}
    t0 = time.perf_counter()
    for res in router.serve(iter(reqs)):
        seen[res.payload] = seen.get(res.payload, 0) + 1
        results[res.payload] = res
        if kill_after is not None and len(results) == kill_after:
            os.kill(router.host_pid(0), signal.SIGKILL)
    return results, time.perf_counter() - t0, seen


def _fleet_cli(root: Path, name: str, extra, sample_apps: bool = False) -> dict:
    """``python -m raft_stereo_tpu_torch.serve_fleet`` as its own process
    (the router's); its summary, wall seconds and telemetry events, and,
    with ``sample_apps``, ``nvidia-smi``'s compute processes every 0.5 s
    while it serves. The router's process group is killed on a timeout."""
    import os
    import signal
    import threading

    tel_dir = root / name
    argv = [sys.executable] + FLEET_CLI + ["--name", name, "--telemetry_dir", str(tel_dir)] \
        + FLEET_CLI_ARGV + list(extra)
    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    samples, stop = [], threading.Event()
    before = _compute_apps() if sample_apps else None

    def sampler():
        while not stop.wait(0.5):
            samples.append(_compute_apps())

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    thread = threading.Thread(target=sampler, daemon=True)
    if sample_apps:
        thread.start()
    try:
        out, err = proc.communicate(timeout=FLEET_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"fleet_path: serve_fleet {name} ran past "
                             f"{FLEET_CLI_TIMEOUT_S:.0f}s: {err[-4000:]}")
    finally:
        stop.set()
        if sample_apps:
            thread.join(timeout=10)
    wall = time.perf_counter() - t0
    (root / f"{name}.stderr.txt").write_text(err)
    if proc.returncode != 0:
        raise AssertionError(f"fleet_path: serve_fleet {name} exit {proc.returncode}: "
                             f"{err[-4000:]}")
    summary = json.loads(out.strip().splitlines()[-1])["serve_fleet"]
    return {"argv": argv[1 + len(FLEET_CLI):], "router_pid": proc.pid, "wall_s": wall, "summary": summary,
            "events": _events_of(tel_dir), "workdir": tel_dir / "fleet", "samples": samples,
            "before": before}


def phase_fleet_path(tmp: Path):
    """The replica fleet (``runtime/fleet.py``, ``serve_fleet.py``) on one
    card, MADNet2 (the JAX ``MADNet2Config`` widths, seeded weights, fp32)
    at KITTI 2015's 375x1242, batch 2, each worker its own process with its
    own captured graph:
    (a) 96 in-memory requests through a 2-host ``FleetRouter`` in this
        process, twice, every output bitwise this process's single-host
        engine and scheduler on the same weights and batch; no failover,
        fence, shed or ``fleet_host_down``; one capture per engine key in
        each worker (its telemetry);
    (b) the same with host 0 SIGKILLed after FLEET_KILL_AFTER results:
        every payload resolved once, ``failovers >= 1``, no typed loss,
        completions bitwise (a)'s;
    (c) ``serve_fleet --rolling_restart_after 24`` as its own process: no
        failed request, each host respawned once, ``fleet_drain`` begin and
        complete bracketing each host in turn;
    (d) ``serve_fleet --source video --video_sessions 2``: each session on
        one host (no host went down), the router's pid never among
        ``nvidia-smi``'s compute processes while the workers serve, and its
        own CUDA uninitialised;
    (e) recorded, not bounded: pairs/s over the 96 requests at 1 and 2
        hosts (the second serve of each router: graphs captured), the
        single host's in this process, each worker's seconds from launch to
        its portfile and to its first healthy poll, each worker's device
        memory, the wire's ms a frame (the router's pickle and send, the
        workers' receive and unpickle, the router's of each result), the
        phase's seconds. The workers are other processes: their kernel counters are
        not read here (MADNet2 runs none of K1-K3)."""
    import torch

    from raft_stereo_tpu_torch import serve_fleet
    from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.ops.pad import bucket_shape
    from raft_stereo_tpu_torch.runtime import telemetry
    from raft_stereo_tpu_torch.runtime.fleet import FleetRouter
    from raft_stereo_tpu_torch.runtime.infer import InferOptions
    from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler

    t_phase = time.perf_counter()
    root = tmp / "fleet"
    root.mkdir()
    reqs = _fleet_pairs(FLEET_REQUESTS)
    kw = {"model": "madnet2", "device": FLEET_DEVICE, "batch": FLEET_BATCH,
          "infer_timeout": 300.0, "retries": 2}
    flags = {"cudnn_benchmark": torch.backends.cudnn.benchmark,
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if flags != {"cudnn_benchmark": False, "cudnn_allow_tf32": True,
                 "matmul_allow_tf32": False}:
        raise AssertionError(f"fleet_path: this process is not at torch's defaults, as the "
                             f"workers are: {flags}")

    # the single-host reference: this process's engine and scheduler, on the
    # workers' weights (serve_fleet.build_engine's seed 0)
    model = make_madnet2(seed=0, device=FLEET_DEVICE)
    engine = make_mad_engine(model, infer=InferOptions(batch=FLEET_BATCH))
    sched = ContinuousBatchingScheduler(engine, max_wait_s=FLEET_MAX_WAIT_S)
    ref = {r.payload: r.output for r in sched.serve(iter(reqs))}
    t0 = time.perf_counter()
    again = {r.payload: r for r in sched.serve(iter(reqs))}
    single_s = time.perf_counter() - t0
    if sorted(ref) != list(range(FLEET_REQUESTS)) or _bitwise(again, ref)["bitwise_equal"] \
            != FLEET_REQUESTS:
        raise AssertionError("fleet_path: the single-host reference is not stable")
    del model, engine, sched, again
    if FLEET_DEVICE == "cuda":
        torch.cuda.empty_cache()

    def in_process(name, n_hosts, serves, kill_after=None):
        """A ``FleetRouter`` in this process, its own telemetry directory:
        ``serves`` serves of ``reqs``; each serve's results, seconds and
        resolutions a payload, the snapshot, the router's events."""
        tel = telemetry.install(telemetry.Telemetry(str(root / name / "router")))
        fr = FleetRouter(serve_fleet.FACTORY, n_hosts, factory_kw=kw,
                         workdir=str(root / name), max_wait_s=FLEET_MAX_WAIT_S)
        try:
            t0 = time.perf_counter()
            fr.start()
            start_s = time.perf_counter() - t0
            runs = [_fleet_serve(fr, reqs, kill_after=kill_after if k == 0 else None)
                    for k in range(serves)]
            snap = fr.snapshot()
        finally:
            fr.close()
            telemetry.uninstall(tel)
        return {"start_s": start_s, "serves": runs, "snapshot": snap,
                "events": _events_of(root / name / "router"),
                "captures": _worker_captures(root / name, n_hosts)}

    # (a) fault-free, twice (the second serve's rate is (e)'s at 2 hosts)
    run_a = in_process("a", 2, serves=2)
    # (b) SIGKILL host 0 a third of the way in
    run_b = in_process("b", 2, serves=1, kill_after=FLEET_KILL_AFTER)
    # (e) one host, twice
    run_e = in_process("e", 1, serves=2)
    # (c) rolling restart, (d) video sessions: the CLI, the router its own process
    cli_c = _fleet_cli(root, "c", ["--num_requests", str(FLEET_RESTART_REQUESTS),
                                   "--rolling_restart_after", str(FLEET_RESTART_AFTER)])
    cli_d = _fleet_cli(root, "d", ["--source", "video", "--video_sessions", "2",
                                   "--num_requests", str(FLEET_VIDEO_REQUESTS)],
                       sample_apps=True)

    def counted(ev, name):
        return [e for e in ev if e["event"] == name]

    def rate(serve):
        return len(serve[0]) / serve[1]

    # (a)
    a_bits = [_bitwise(s[0], ref) for s in run_a["serves"]]
    a_snap = run_a["snapshot"]
    # (b)
    b_results, _b_s, b_seen = run_b["serves"][0]
    b_snap = run_b["snapshot"]
    b_done = {k: r for k, r in b_results.items() if r.ok}
    b_bits = _bitwise(b_done, ref)
    # (c)
    c_sum, c_ev = cli_c["summary"], cli_c["events"]
    drains = [(e["host"], e["phase"]) for e in counted(c_ev, "fleet_drain")]
    # (d)
    d_sum, d_ev = cli_d["summary"], cli_d["events"]
    d_routes = counted(d_ev, "fleet_route")
    sessions = {}
    for e in d_routes:
        sessions.setdefault(e["session"], set()).add(e["host"])
    d_pids = {int(v["pid"]) for v in d_sum["hosts"].values()}
    samples = cli_d["samples"]
    apps_seen = sorted({pid for s in samples for pid, _ in s["apps"]})
    peak = max(samples, key=lambda s: s["used_mib"]) if samples else None
    n_before = len(cli_d["before"]["apps"])
    worker_mib = {
        "by_pid": {str(pid): max((m for s in samples for p, m in s["apps"] if p == pid),
                                 default=None) for pid in sorted(d_pids)},
        "card_used_before": cli_d["before"]["used_mib"],
        "card_used_peak": peak["used_mib"] if peak else None,
        "per_worker_from_card": ((peak["used_mib"] - cli_d["before"]["used_mib"]) / 2
                                 if peak else None),
        "entries_at_peak": peak["apps"] if peak else None}
    # processes holding a context while the fleet serves, beyond this one's
    entries_added = max((len(s["apps"]) for s in samples), default=0) - n_before
    res = {
        "phase": "fleet_path", "model": "madnet2 (MADNet2Config widths, seed 0, fp32)",
        "hw": list(FLEET_HW), "batch": FLEET_BATCH, "requests": FLEET_REQUESTS,
        "torch_flags": flags,
        "launches": "not counted: the workers are other processes; MADNet2 runs none of K1-K3",
        "single_host": {"pairs_per_s": FLEET_REQUESTS / single_s, "seconds": single_s},
        "fault_free": {
            "start_s": run_a["start_s"], "bitwise": a_bits,
            "counters": {k: a_snap[k] for k in ("routed", "failovers", "fenced",
                                                "typed_losses", "shed")},
            "host_down": len(counted(run_a["events"], "fleet_host_down")),
            "routes_by_host": {h: v["dispatched"] for h, v in a_snap["hosts"].items()},
            "captures": run_a["captures"], "hosts": _fleet_hosts(a_snap),
            "wire": a_snap["wire"],
            "pairs_per_s": [rate(s) for s in run_a["serves"]]},
        "sigkill": {
            "kill_after": FLEET_KILL_AFTER, "resolved": len(b_seen),
            "resolved_twice": sorted(k for k, c in b_seen.items() if c != 1),
            "completed": len(b_done), "bitwise": b_bits,
            "errors": sorted({type(r.error).__name__ for r in b_results.values() if not r.ok}),
            "counters": {k: b_snap[k] for k in ("failovers", "fenced", "typed_losses")},
            "host_down": [{k: e.get(k) for k in ("host", "reason", "inflight")}
                          for e in counted(run_b["events"], "fleet_host_down")],
            "failover_outcomes": sorted({e["outcome"] for e in
                                         counted(run_b["events"], "fleet_failover")}),
            "hosts": _fleet_hosts(b_snap)},
        "rolling_restart": {
            "argv": cli_c["argv"], "wall_s": cli_c["wall_s"], "served": c_sum["served"],
            "failed": c_sum["failed"], "drains": drains,
            "host_down_reasons": sorted({e["reason"] for e in
                                         counted(c_ev, "fleet_host_down")}),
            "hosts": _fleet_hosts(c_sum), "captures": _worker_captures(cli_c["workdir"], 2)},
        "video": {
            "argv": cli_d["argv"], "wall_s": cli_d["wall_s"], "served": d_sum["served"],
            "failed": d_sum["failed"], "sessions": {s: sorted(h) for s, h in sessions.items()},
            "host_down": len(counted(d_ev, "fleet_host_down")),
            "router_pid": cli_d["router_pid"], "worker_pids": sorted(d_pids),
            "compute_apps_seen": apps_seen, "samples": len(samples),
            "compute_apps_before": cli_d["before"]["apps"],
            "compute_apps_added_max": entries_added, "worker_mib": worker_mib,
            "router_cuda_initialized": d_sum["router_cuda_initialized"],
            "hosts": _fleet_hosts(d_sum)},
        "recorded": {
            "pairs_per_s": {"hosts_1": rate(run_e["serves"][1]),
                            "hosts_2": rate(run_a["serves"][1]),
                            "single_host_in_process": FLEET_REQUESTS / single_s,
                            "first_serve_hosts_1": rate(run_e["serves"][0]),
                            "first_serve_hosts_2": rate(run_a["serves"][0])},
            "one_host_bitwise": [_bitwise(s[0], ref) for s in run_e["serves"]],
            "launch_to_portfile_s": {r: {h: v["spawn_s"] for h, v in s["hosts"].items()}
                                     for r, s in (("a", a_snap), ("b", b_snap),
                                                  ("e", run_e["snapshot"]), ("c", c_sum),
                                                  ("d", d_sum))},
            "launch_to_healthy_s": {r: {h: v["ready_s"] for h, v in s["hosts"].items()}
                                    for r, s in (("a", a_snap), ("b", b_snap),
                                                 ("e", run_e["snapshot"]), ("c", c_sum),
                                                 ("d", d_sum))},
            # ms a frame: the router's pickle and send, the workers'
            # receive and unpickle, the router's of each result
            "wire_ms": {"hosts_2": a_snap["wire"], "hosts_1": run_e["snapshot"]["wire"]},
            "worker_device_mib": worker_mib},
        "seconds": time.perf_counter() - t_phase, "card": smi_line(),
    }
    emit(res)
    del reqs, run_a, run_b, run_e, b_results, b_done
    fails = []
    if any(b["bitwise_equal"] != FLEET_REQUESTS for b in a_bits) or \
            any(res["fault_free"]["counters"][k] for k in ("failovers", "fenced",
                                                             "typed_losses")) or \
            a_snap["shed"] or res["fault_free"]["host_down"]:
        fails.append("(a) fault-free")
    bucket = bucket_shape(*FLEET_HW, 128)
    key = f"{bucket[0]}x{bucket[1]}/b{FLEET_BATCH}"
    if any(v["by_key"] != {key: 1} for v in res["fault_free"]["captures"].values()):
        fails.append("(a) captures")
    if res["sigkill"]["resolved"] != FLEET_REQUESTS or res["sigkill"]["resolved_twice"] or \
            b_snap["failovers"] < 1 or b_snap["typed_losses"] or \
            b_bits["bitwise_equal"] != b_bits["compared"] or \
            b_bits["compared"] != FLEET_REQUESTS or \
            [d["host"] for d in res["sigkill"]["host_down"]] != [0]:
        fails.append("(b) sigkill")
    if c_sum["served"] != FLEET_RESTART_REQUESTS or c_sum["failed"] or \
            drains != [(0, "begin"), (0, "complete"), (1, "begin"), (1, "complete")] or \
            any(v["incarnation"] != 2 or v["state"] != "up" for v in c_sum["hosts"].values()) \
            or set(res["rolling_restart"]["host_down_reasons"]) - {"drain_exit"}:
        fails.append("(c) rolling restart")
    if d_sum["served"] != FLEET_VIDEO_REQUESTS or d_sum["failed"] or \
            sorted(sessions) != ["video0", "video1"] or \
            any(len(h) != 1 for h in sessions.values()) or res["video"]["host_down"]:
        fails.append("(d) video sessions")
    if d_sum["router_cuda_initialized"] or cli_d["router_pid"] in apps_seen or \
            not samples or entries_added > 2:
        fails.append("(d) the router holds a CUDA context")
    if fails:
        raise AssertionError(f"fleet_path: {fails}")
    return res


# The spatial tier (``spatial_path``): the quality tier's pairs and the
# megapixel ones (bucket 1024x1440, 1.47 MP) above the routing bar, and the
# shard counts the sharded forward runs at on the one card.
SPATIAL_HW = (544, 960)
SPATIAL_BIG_HW = (992, 1440)
SPATIAL_THRESHOLD = 1_000_000
SPATIAL_K = (2, 4)


def _spatial_pair(H: int, W: int, seed: int):
    """One seeded in-memory pair as ``_write_pairs`` makes them: a smoothed
    random texture and a copy shifted by 20 px, float32 [H, W, 3]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    tex = rng.rand(H, W + 64, 3)
    for axis in (0, 1):
        tex = sum(np.roll(tex, s, axis=axis) for s in range(-2, 3)) / 5.0
    tex = (tex * 255).astype(np.float32)
    return np.ascontiguousarray(tex[:, 32:32 + W]), np.ascontiguousarray(tex[:, 52:52 + W])


@contextlib.contextmanager
def _short_conv_halo():
    """A planted fault: every conv's halo one row short, its farthest
    neighbour row read as zeros."""
    from raft_stereo_tpu_torch.parallel import spatial

    conv2d, halo = spatial.conv2d, spatial.halo

    def short_halo(slabs, above, below, dim=2, zeros=True):
        out = halo(slabs, above, below, dim, zeros)
        for i, t in enumerate(out):
            if i > 0 and above:
                t.narrow(dim, 0, 1).zero_()
            if i < len(out) - 1 and below:
                t.narrow(dim, t.shape[dim] - 1, 1).zero_()
        return out

    def faulty(*args, **kw):
        spatial.halo = short_halo
        try:
            return conv2d(*args, **kw)
        finally:
            spatial.halo = halo

    spatial.conv2d = faulty
    try:
        yield
    finally:
        spatial.conv2d = conv2d


def phase_spatial_path(tmp: Path):
    """The spatial tier on the one card, shards on ``[cuda:0] * k``, with
    the raftstereo-middlebury preset (bf16, alt lookup, seeded weights):

      * parity: the sharded forward at k = 2 and 4 against the unsharded one
        at 544x960, one iteration (32 amplify rounding, ENGINE_PER_IMAGE_TOL's
        note), within ENGINE_PER_IMAGE_TOL, which a planted conv halo one
        row short must exceed; in fp32 (TF32 off) at two iterations from a
        seeded initial flow, the unfused and the fused (``--fused_update``,
        one K2 step a shard) forward within PARITY_ATOL_* / PARITY_RTOL,
        which K2 on slabs extended by one row too few must exceed; the bf16
        fused variant's difference reported;
      * the path (counts set to 0 before, read after): the fused variant,
        the sharded forward at 32 iterations at k = 2 and 4 (K1 launches 32·k
        a pair, one a lookup a shard), a ``SpatialServer`` stream of 6 pairs
        at 544x960 and 2 at 992x1440 at batch 2 with the bar at 1,000,000 px
        and the spatial tier at k = 2 (2 routed, none degraded, each routed
        output bitwise the spatial engine's for the same input and each
        other the quality engine's), and ``evaluate --spatial_threshold``
        on the synthetic ETH3D tree (one shard on one card);
      * the packed encoder stage per slab (K3, ``_ENABLE_PACKED``) with the
        raftstereo-realtime preset at 544x960: bf16 at one iteration within
        ENGINE_PER_IMAGE_TOL of the unsharded packed forward, fp32 at two
        within PARITY_ATOL_*, which K3 on slabs with no halo row
        (``K3_HALO_ROWS`` 0) must exceed; on the path, the sharded packed
        forward at 7 iterations at k = 2 and 4 (K3 4·k launches a forward);
      * reported only: the 1024x1440 pair at k = 1, 2 and 4, 32 iterations:
        device ms of its captured forward (CUDA events around replays), ms
        eager (host launches included) and the eager run's peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.experiments import packed_conv
    from raft_stereo_tpu_torch.models import extractor, raft_stereo_spatial
    from raft_stereo_tpu_torch.models.raft_stereo_spatial import SpatialRAFTStereo
    from raft_stereo_tpu_torch.ops import alt_corr, fused_update
    from raft_stereo_tpu_torch.ops.pad import InputPadder
    from raft_stereo_tpu_torch.runtime import tiers as tiers_mod
    from raft_stereo_tpu_torch.runtime.infer import GraphCache, InferOptions, InferRequest

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = PRESETS["raftstereo-middlebury"]
    model = load_model(cfg, device=dev, seed=SEED)
    fused_model = load_model(dataclasses.replace(cfg, fused_update=True), device=dev, seed=SEED)
    small = [_spatial_pair(*SPATIAL_HW, SEED + 40 + i) for i in range(6)]
    big = [_spatial_pair(*SPATIAL_BIG_HW, SEED + 50 + i) for i in range(2)]
    a, b = (torch.from_numpy(x)[None].to(dev) for x in small[0])

    def diff(got, want):
        return _diff_stats([(got.float() - want.float()).abs().cpu().numpy()])

    def within(st):
        return all(st[k] <= v for k, v in ENGINE_PER_IMAGE_TOL.items())

    def fp32_errors(got, want):
        """The largest |got - want| of lowres and disp_up, each over its
        PARITY_ATOL_* + PARITY_RTOL·|want| (within the limit at <= 1)."""
        return max(float(((g - w).abs() / (atol + PARITY_RTOL * w.abs())).max())
                   for g, w, atol in zip(got, want, (PARITY_ATOL_LOWRES, PARITY_ATOL_UP)))

    with _launches_kept(), torch.no_grad():
        ref = model(a, b, iters=1)[1]
        parity = {f"k{k}": diff(SpatialRAFTStereo(model, [dev] * k)(a, b, iters=1)[1], ref)
                  for k in SPATIAL_K}
        with _short_conv_halo():
            planted = diff(SpatialRAFTStereo(model, [dev] * 2)(a, b, iters=1)[1], ref)
        fused_ref = fused_model(a, b, iters=2)[1]
    # a seeded initial flow: the first K2 step's delta then depends on the
    # flow 9 rows away (from a zero flow the ninth row adds nothing)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flow0 = 8.0 * torch.randn((1, SPATIAL_HW[0] // 4, SPATIAL_HW[1] // 4, 2), generator=g,
                              device=dev)
    fp32 = {}
    with _fp32_checks(), torch.no_grad():
        for fused in (False, True):
            m32 = load_model(dataclasses.replace(cfg, mixed_precision=False, fused_update=fused),
                             device=dev, seed=SEED)
            want32 = m32(a, b, iters=2, flow_init=flow0)
            name = "fused" if fused else "unfused"
            for k in SPATIAL_K:
                fp32[f"{name}_k{k}"] = fp32_errors(
                    SpatialRAFTStereo(m32, [dev] * k)(a, b, iters=2, flow_init=flow0), want32)
            if fused:
                saved_rows = raft_stereo_spatial.K2_HALO_ROWS
                raft_stereo_spatial.K2_HALO_ROWS = saved_rows - 1
                try:
                    fp32["fused_k2_planted_halo_rows_8"] = fp32_errors(
                        SpatialRAFTStereo(m32, [dev] * 2)(a, b, iters=2, flow_init=flow0),
                        want32)
                finally:
                    raft_stereo_spatial.K2_HALO_ROWS = saved_rows
            del m32, want32

    # the packed stage per slab, on the realtime preset
    rt_cfg = PRESETS["raftstereo-realtime"]
    rt_model = load_model(rt_cfg, device=dev, seed=SEED)
    saved_packed = extractor._ENABLE_PACKED
    extractor._ENABLE_PACKED = True
    packed_fp32 = {}
    try:
        with _launches_kept(), torch.no_grad():
            rt_ref = rt_model(a, b, iters=1)[1]
            packed_parity = {f"k{k}": diff(SpatialRAFTStereo(rt_model, [dev] * k)(
                a, b, iters=1)[1], rt_ref) for k in SPATIAL_K}
        with _fp32_checks(), torch.no_grad():
            m32 = load_model(dataclasses.replace(rt_cfg, mixed_precision=False), device=dev,
                             seed=SEED)
            want32 = m32(a, b, iters=2)
            for k in SPATIAL_K:
                packed_fp32[f"k{k}"] = fp32_errors(
                    SpatialRAFTStereo(m32, [dev] * k)(a, b, iters=2), want32)
            saved_rows = raft_stereo_spatial.K3_HALO_ROWS
            raft_stereo_spatial.K3_HALO_ROWS = 0
            try:
                packed_fp32["k3_planted_no_halo_k2"] = fp32_errors(
                    SpatialRAFTStereo(m32, [dev] * 2)(a, b, iters=2), want32)
            finally:
                raft_stereo_spatial.K3_HALO_ROWS = saved_rows
            del m32, want32
    finally:
        extractor._ENABLE_PACKED = saved_packed

    _zero_launches()
    k2_before = fused_update.LAUNCHES
    fused_out = SpatialRAFTStereo(fused_model, [dev] * 2)(a, b, iters=2)[1]
    fused_k2 = fused_update.LAUNCHES - k2_before
    fused_parity = diff(fused_out, fused_ref)
    k1_a_pair, finite = {}, True
    for k in SPATIAL_K:
        before = alt_corr.LAUNCHES
        out = SpatialRAFTStereo(model, [dev] * k)(a, b, iters=32)[1]
        k1_a_pair[f"k{k}"] = alt_corr.LAUNCHES - before
        finite = finite and bool(torch.isfinite(out).all())
    k3_a_forward = {}
    extractor._ENABLE_PACKED = True
    try:
        for k in SPATIAL_K:
            before = packed_conv.LAUNCHES
            out = SpatialRAFTStereo(rt_model, [dev] * k)(a, b, iters=7)[1]
            k3_a_forward[f"k{k}"] = packed_conv.LAUNCHES - before
            finite = finite and bool(torch.isfinite(out).all())
    finally:
        extractor._ENABLE_PACKED = saved_packed

    ts = tiers_mod.TierSet(
        [tiers_mod.raft_stereo_tier(model, 32),
         tiers_mod.spatial_tier(model, 32, num_spatial=2, devices=[dev] * 2)],
        InferOptions(batch=2, sched=True, deadline_s=300.0))
    server = tiers_mod.SpatialServer(ts, base="quality", spatial="spatial",
                                     threshold=SPATIAL_THRESHOLD)
    # the megapixel pairs arrive together, so the spatial tier serves them
    # as one batch
    pairs = small[:2] + big + small[2:]
    is_big = [False, False, True, True, False, False, False, False]
    t0 = time.perf_counter()
    results = {r.payload: r for r in server.serve(
        iter([InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs)]))}
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    replayed = _replayed(ts)
    with _launches_kept():
        spatial_out = {r.payload: r.output for r in ts.engines["spatial"].stream(iter(
            [InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs) if is_big[i]]))}
        quality_out = {r.payload: r.output for r in ts.engines["quality"].stream(iter(
            [InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs) if not is_big[i]]))}
    want = {**spatial_out, **quality_out}
    bitwise = sum(int(i in results and results[i].ok and want[i].shape == results[i].output.shape
                      and np.array_equal(results[i].output, want[i])) for i in want)
    routing = {
        "requests": len(pairs), "ok": sum(r.ok for r in results.values()),
        "spatial_routed": ts.schedulers["quality"].stats.spatial_routed,
        "degraded": {n: e.stats.degraded for n, e in ts.engines.items()},
        "images": {n: e.stats.images for n, e in ts.engines.items()},
        "bitwise_each_tier_engine": bitwise, "serve_s": serve_s,
        "tiers": _tiers_report(ts),
        "spatial_engine": {k: ts.engines["spatial"].snapshot()[k]
                           for k in ("num_spatial", "divis_h", "active_shards", "capture")},
    }

    root = _eth3d_tree(tmp)
    # the 480x720 scenes (bucket 480x736, 353,280 px) route, the 400x640 ones
    # (416x640) stay on the quality tier
    argv = ["--dataset", "eth3d", "--preset", "raftstereo-middlebury", "--valid_iters", "32",
            "--infer_batch", "2", "--spatial_threshold", "300000"]
    with _chdir(root), _recorded_predictions() as cli:
        cli_metrics = evaluate.main(argv)
    cli_routed = cli["serving"].tier_set.schedulers["quality"].stats.spatial_routed
    # the eager launches, the warm-ups' and the captures', and each graph's
    # at capture x replays
    cli_replayed = _replayed(cli["serving"])
    launches = {k: n + replayed[k] + cli_replayed[k] for k, n in _launches().items()}

    timing = {}
    pad = InputPadder((1, *SPATIAL_BIG_HW, 3), divis_by=32)
    x, y = (torch.from_numpy(t)[None].to(dev) for t in big[0])
    x, y = pad.pad(x, y)
    mp = x.shape[1] * x.shape[2] / 1e6
    with _launches_kept(), torch.no_grad():
        for k in (1, *SPATIAL_K):
            sharded = SpatialRAFTStereo(model, [dev] * k)
            sharded(x, y, iters=32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eager_ms = _time_ms(lambda: sharded(x, y, iters=32), reps=2, warmup=0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            graphs = GraphCache()
            entry = graphs.get(k, lambda p, q: sharded(p, q, iters=32)[1], (x, y))
            ms = _time_ms(lambda: graphs.replay(entry, (x, y)), reps=3, warmup=1)
            del graphs, entry
            timing[f"k{k}"] = {"device_ms": ms, "device_ms_per_mp": ms / mp,
                               "eager_ms": eager_ms, "peak_gib": peak,
                               "peak_gib_per_mp": peak / mp}
    res = {"phase": "spatial_path", "entry": "raft_stereo_tpu_torch.runtime.tiers.SpatialServer",
           "preset": "raftstereo-middlebury", "parity_1_iter": parity,
           "planted_short_halo_1_iter": planted, "tol": ENGINE_PER_IMAGE_TOL,
           "fp32_2_iter_of_limit": fp32,
           "fused_bf16_2_iter": {"k": 2, "k2_launches": fused_k2, "parity": fused_parity},
           "k1_launches_a_pair_32_iters": k1_a_pair,
           "packed_realtime": {"bf16_1_iter": packed_parity, "fp32_2_iter_of_limit": packed_fp32,
                               "k3_launches_a_forward_7_iters": k3_a_forward},
           "routing": routing,
           "evaluate_cli": {"argv": argv, "metrics": cli_metrics, "spatial_routed": cli_routed},
           "timing_1024x1440_32_iters": {"megapixels": mp, **timing},
           "k1_slab_check": "kernel_check spatial_slab_k2_544x960",
           "launches": launches, "seconds": time.perf_counter() - t_phase, "card": smi_line()}
    emit(res)
    fails = []
    if not all(within(st) for st in parity.values()):
        fails.append("parity at 1 iteration")
    if within(planted):
        fails.append("the planted short halo passes the limit")
    if any(v > 1 for n, v in fp32.items() if "planted" not in n):
        fails.append("fp32 parity at 2 iterations")
    if fp32["fused_k2_planted_halo_rows_8"] <= 1:
        fails.append("K2 on slabs one row short passes the limit")
    if fused_k2 != 2:
        fails.append("K2 launches in the fused variant")
    if any(n != 32 * int(k[1:]) for k, n in k1_a_pair.items()) or not finite:
        fails.append("K1 launches a pair")
    if (routing["ok"] != len(pairs) or routing["spatial_routed"] != 2
            or any(routing["degraded"].values()) or bitwise != len(pairs)):
        fails.append("routing")
    if cli_routed != 4 or not all(math.isfinite(v) for v in cli_metrics.values()):
        fails.append("evaluate --spatial_threshold")
    if not all(within(st) for st in packed_parity.values()):
        fails.append("the packed stage's parity at 1 iteration")
    if any(v > 1 for n, v in packed_fp32.items() if "planted" not in n):
        fails.append("the packed stage's fp32 parity at 2 iterations")
    if packed_fp32["k3_planted_no_halo_k2"] <= 1:
        fails.append("K3 on slabs with no halo row passes the limit")
    if any(n != 4 * int(k[1:]) for k, n in k3_a_forward.items()):
        fails.append("K3 launches a forward")
    if fails:
        raise AssertionError(f"spatial_path: {fails}")
    return res


# ------------------------------------------------------------ the graph store

AOT_CHILD_TIMEOUT_S = 300.0
# each CLI twice on one fresh --aot_dir: (name, cwd from tmp, argv)
AOT_EVAL_ARGV = ["--dataset", "eth3d", "--preset", "raftstereo-middlebury",
                 "--valid_iters", "32"]
# controller_path's configuration without the controller and the scheduler
# (whose timing-driven groups are not the store's to hold), and frozen
# weights: every escalation is served and every output compared
AOT_CASCADE_ARGV = ["--source", "synthetic", "--synthetic_size", "375", "1242",
                    "--infer_batch", "2", "--cascade", "--cascade_threshold", "0.99",
                    "--quality_iters", "8", "--no_adapt", "--num_requests", "8"]
AOT_FLEET_ARGV = FLEET_CLI_ARGV + ["--num_requests", "16"]


def aot_child_main(cli: str, out: str, argv) -> int:
    """``python3 chip_smoke.py aot-child CLI OUT ARGV...``: one run of
    ``raft_stereo_tpu_torch.<CLI>.main(ARGV)`` in this process (an
    ``aot_path`` child), which writes to OUT and prints one JSON line: the
    result (metrics or summary), every served output's sha256 by engine
    tier and payload (the fleet's router: by payload), each engine's build
    seconds (its prewarm included), prewarmed keys, captures and first
    request's end-to-end seconds, and the kernel launches (the counters:
    warm-ups, captures, eager; plus each graph's launches x replays)."""
    import hashlib
    import importlib

    import numpy as np
    import torch

    from raft_stereo_tpu_torch.runtime import infer
    from raft_stereo_tpu_torch.runtime.fleet import FleetRouter

    mod = importlib.import_module(f"raft_stereo_tpu_torch.{cli}")
    engines, digests, first_e2e, snaps = [], {}, {}, []

    def digest(x):
        return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]

    init = infer.InferenceEngine.__init__

    def timed_init(self, *a, **kw):
        t0 = time.perf_counter()
        init(self, *a, **kw)
        engines.append((self, time.perf_counter() - t0))

    finalize = infer.InferenceEngine._finalize

    def recorded_finalize(self, dispatched):
        for r in finalize(self, dispatched):
            if r.ok:
                digests[f"{self.tier_label}:{r.payload}"] = digest(r.output)
            yield r

    observe = infer.InferStats.observe_latency

    def first_observed(self, component, label, seconds):
        if component == "e2e":
            first_e2e.setdefault(id(self), seconds)
        observe(self, component, label, seconds)

    serve = FleetRouter.serve

    def recorded_serve(self, requests):
        for r in serve(self, requests):
            if r.ok:
                digests[f"fleet:{r.payload}"] = digest(r.output)
            yield r
        snaps.append(self.snapshot())

    infer.InferenceEngine.__init__ = timed_init
    infer.InferenceEngine._finalize = recorded_finalize
    infer.InferStats.observe_latency = first_observed
    FleetRouter.serve = recorded_serve
    t0 = time.perf_counter()
    result = mod.main(list(argv))
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replayed = {k: 0 for k in infer.kernel_launches()}
    for eng, _ in engines:
        for k, n in eng.graphs.replayed_launches.items():
            replayed[k] += n
    doc = {"cli": cli, "argv": list(argv), "wall_s": wall,
           "result": result if isinstance(result, dict) else None,
           "digests": digests,
           "engines": [{"tier": e.tier_label, "build_s": dt, "prewarmed": e.stats.prewarmed,
                        "compiles": e.stats.compiles, "captures": e.graphs.captures,
                        "first_e2e_s": first_e2e.get(id(e.stats)),
                        "store": e.snapshot()["aot_store"]} for e, dt in engines],
           "launches": infer.kernel_launches(), "replayed_launches": replayed,
           "fleet_hosts": snaps[-1]["hosts"] if snaps else None}
    line = json.dumps(doc, default=str)
    Path(out).write_text(line)
    print("aot-child " + line, flush=True)
    return 0


def _aot_child(cli: str, root: Path, out: Path, argv) -> dict:
    """One ``aot-child`` process in ``root`` (the process group killed on a
    timeout); its JSON document."""
    import os
    import signal

    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, str(Path(__file__).resolve()), "aot-child", cli, str(out), *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=AOT_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        raise AssertionError(f"aot_path: {cli} ran past {AOT_CHILD_TIMEOUT_S:.0f}s: "
                             f"{err[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"aot_path: {cli} exit {proc.returncode}: {err[-4000:]}")
    doc = json.loads(out.read_text())
    doc["process_s"] = time.perf_counter() - t0
    return doc


def _store_events(run_dirs) -> dict:
    """Counts of the store's and the compiles' events over run directories
    (every ``events.jsonl`` under each)."""
    counts = {}
    for d in run_dirs:
        for p in Path(d).rglob("events.jsonl"):
            for e in _events_of(p.parent):
                if e["event"].startswith("aot_store") or e["event"] == "bucket_compile":
                    counts[e["event"]] = counts.get(e["event"], 0) + 1
    return counts


def phase_aot_path(tmp: Path):
    """The persistent graph store (``runtime/aot_store.py``, ``--aot_dir``):
    three CLIs, each run twice as a child process on one fresh store:
    ``evaluate --dataset eth3d`` (raftstereo-middlebury, bf16, alt: K1) on
    the synthetic ETH3D tree, ``serve_adaptive --cascade`` (the
    controller_path's model configuration: MADNet2 and the 8-iteration
    raftstereo at 375x1242, batch 2) and ``serve_fleet`` (2 MADNet2 workers,
    16 requests). On each second run: an ``aot_store_hit`` for every key
    the first committed (the fleet: in each worker), zero
    ``bucket_compile``, and the result and every output bitwise the first
    run's. Recorded: each engine's build seconds with its prewarm, the
    first request's end-to-end seconds cold and warm (the cascade's: the
    quality tier's first escalated batch), the fleet's launch-to-healthy
    seconds, and K1's launches in the evaluate children (their logs)."""
    t_phase = time.perf_counter()
    base = tmp / "aot"
    base.mkdir()
    eth3d = _eth3d_tree(tmp)
    runs, fails = {}, []
    for cli, cwd, argv, tel_flag in (
            ("evaluate", eth3d, AOT_EVAL_ARGV, True),
            ("serve_adaptive", base, AOT_CASCADE_ARGV, False),
            ("serve_fleet", base, AOT_FLEET_ARGV, False)):
        store = base / f"store_{cli}"
        pair = []
        for turn in ("cold", "warm"):
            tel = base / f"{cli}_{turn}"
            extra = ["--aot_dir", str(store), "--telemetry_dir", str(tel)]
            if not tel_flag:
                extra += ["--name", f"{cli}_{turn}"]
            doc = _aot_child(cli, cwd, base / f"{cli}_{turn}.json", argv + extra)
            doc["events"] = _store_events([tel])
            doc["store_entries"] = sum(1 for p in store.iterdir()
                                       if p.name.endswith(".manifest.json"))
            pair.append(doc)
        cold, warm = pair
        keys = cold["store_entries"]
        by_host = None
        if cli == "serve_fleet":
            by_host = {h.name: _store_events([h]) for h in
                       sorted((base / f"{cli}_warm" / "fleet").glob("host*")) if h.is_dir()}
            hits_ok = len(by_host) == 2 and all(
                ev.get("aot_store_hit", 0) == keys for ev in by_host.values())
        else:
            hits_ok = warm["events"].get("aot_store_hit", 0) == keys
        same_result = cold["result"] == warm["result"] if cli != "serve_fleet" else (
            (cold["result"]["served"], cold["result"]["failed"])
            == (warm["result"]["served"], warm["result"]["failed"]))
        report = {
            "keys_committed": keys, "events": {"cold": cold["events"], "warm": warm["events"]},
            "warm_hits_by_host": by_host, "hits_every_key": hits_ok,
            "result_equal": same_result,
            "outputs": {"compared": len(cold["digests"]),
                        "bitwise_equal": sum(warm["digests"].get(k) == v
                                             for k, v in cold["digests"].items()),
                        "keys_match": sorted(cold["digests"]) == sorted(warm["digests"])},
            "engines": {"cold": cold["engines"], "warm": warm["engines"]},
            "process_s": {"cold": cold["process_s"], "warm": warm["process_s"]},
            "wall_s": {"cold": cold["wall_s"], "warm": warm["wall_s"]},
        }
        if cli == "evaluate":
            report["metrics"] = warm["result"]
            report["k1_launches"] = {t: {"counted": d["launches"]["alt_corr"],
                                         "replayed": d["replayed_launches"]["alt_corr"]}
                                     for t, d in (("cold", cold), ("warm", warm))}
        if cli == "serve_fleet":
            report["ready_s"] = {t: {h: v.get("ready_s") for h, v in d["fleet_hosts"].items()}
                                 for t, d in (("cold", cold), ("warm", warm))}
            report["summary_served"] = warm["result"]["served"]
        runs[cli] = report
        if keys < 1 or not hits_ok or warm["events"].get("bucket_compile", 0) \
                or not same_result or report["outputs"]["bitwise_equal"] != len(cold["digests"]) \
                or not report["outputs"]["keys_match"] or not cold["digests"]:
            fails.append(cli)
    ev = runs["evaluate"]
    warm_eval = _aot_child_launches(base / "evaluate_warm.json")
    res = {"phase": "aot_path", "entry": "--aot_dir of evaluate, serve_adaptive, serve_fleet",
           "argv": {"evaluate": AOT_EVAL_ARGV, "serve_adaptive": AOT_CASCADE_ARGV,
                    "serve_fleet": AOT_FLEET_ARGV},
           "runs": runs, "k1_launches_evaluate": ev["k1_launches"],
           "launches": warm_eval, "seconds": time.perf_counter() - t_phase,
           "card": smi_line()}
    emit(res)
    if fails:
        raise AssertionError(f"aot_path: {fails}")
    return res


def _aot_child_launches(path: Path) -> dict:
    """A child's launches: the counters plus each graph's launches x
    replays."""
    doc = json.loads(path.read_text())
    return {k: n + doc["replayed_launches"][k] for k, n in doc["launches"].items()}


# The chaos campaign (``chaos_path``): one seed of each mode at the default
# cadences, the planted violation, and two sched seeds whose forward is the
# realtime preset's packed forward (neither arms ``oom``: a halved batch
# takes other cuDNN algorithms, queue C). The trials run in two lanes at
# once, each trial a child process: the timing-bound invariants held wide
# margins in the CPU campaign (ctrl's p95 off/on 1.8-7.5x, the quality
# swap's latch 5 user results against a budget of 16).
CHAOS_MODE_SEEDS = (0, 4, 6, 8, 9, 10, 12)
CHAOS_VIOLATE_SEED = 1
CHAOS_PACKED_SEEDS = (1, 2)
CHAOS_PACKED_FORWARD = "raft_stereo_tpu_torch.tools.chaos:realtime_packed_forward"
CHAOS_LANES = 2

_emit_lock = threading.Lock()


def _chaos_trial(out: Path, spec: dict, label: str, violate: bool = False) -> dict:
    """One chaos trial on the card (``tools/chaos.py::run_trial``, its child
    a process of its own; with ``violate`` a one-seed ``run_campaign`` of
    the spec's seed with the planted drop, not minimized): its line, report
    and violations."""
    from raft_stereo_tpu_torch.tools import chaos

    out.mkdir(parents=True)
    t0 = time.perf_counter()
    if violate:
        summary = chaos.run_campaign([spec["seed"]], str(out), violate=True, minimize=False,
                                     device="cuda")
        violations, rc = summary["trials"][0]["violations"], None
        spec = chaos.make_spec(spec["seed"], violate=True)
    else:
        violations, rc = chaos.run_trial(spec, str(out), device="cuda")
    wall = time.perf_counter() - t0
    reports = sorted(out.glob("report_*.json"))
    report = json.loads(reports[-1].read_text()) if reports else {}
    if violate:
        # this trial passes when the campaign fails it on the planted drop
        ok = any(v.startswith("resolve_exactly_once") for v in violations)
    else:
        ok = not violations
    line = {"phase": "chaos_trial", "label": label, "seed": spec["seed"], "mode": spec["mode"],
            "faults": [e["kind"] for e in spec["schedule"]], "pass": ok,
            "rc": rc, "wall_s": wall, "violations": [v[:300] for v in violations]}
    with _emit_lock:
        emit(line)
    return {"line": line, "report": report, "violations": violations, "pass": ok}


def _chaos_bitwise(report: dict) -> dict:
    """A trial's completed outputs against its fault-free pass, by sha."""
    done = {p: r for p, r in (report.get("faulted") or {}).get("results", {}).items()
            if r.get("ok")}
    base = (report.get("baseline") or {}).get("results", {})
    both = [p for p in done if base.get(p, {}).get("ok")]
    return {"compared": len(both),
            "bitwise_equal": sum(done[p]["sha"] == base[p]["sha"] for p in both)}


def phase_chaos_path(tmp: Path):
    """The port's seeded chaos campaign (``raft_stereo_tpu_torch/tools/
    chaos.py``) on the card, every trial a child process serving on
    ``cuda`` (captured graphs, replays, the fleet's workers), the trials in
    ``CHAOS_LANES`` lanes at once:
    (a) one seed of each mode (``CHAOS_MODE_SEEDS``: sched, cascade, video,
        ctrl, adaptive, quality, fleet), every invariant green;
    (b) seed 1 with the planted violation: ``resolve_exactly_once`` must
        catch it;
    (c) seeds 1 (sigterm, compile_fail) and 2 (decode_fail) with the
        ``raftstereo-realtime`` preset's packed forward (bf16, 7 iterations)
        at the chaos shapes, whose buckets K3's gate takes: green, every
        completed output bitwise its fault-free pass, K1 and K3 launched
        (read from the children's reports: counters plus replays).
    One line a trial, then the phase's line."""
    from concurrent.futures import ThreadPoolExecutor

    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.experiments import packed_encoder
    from raft_stereo_tpu_torch.tools import chaos

    t_phase = time.perf_counter()
    base = tmp / "chaos"
    fails = []
    # K3's gate at the chaos buckets (the realtime preset's trunks)
    trunk = [m for m in load_model(PRESETS["raftstereo-realtime"], device="cpu").modules()
             if hasattr(m, "norm_fn") and hasattr(getattr(m, "conv1", None), "stride")]
    buckets = sorted({(-(-h // 32) * 32, -(-w // 32) * 32) for h, w in chaos.SHAPES})
    gate = {f"{h}x{w}": [packed_encoder.packable_hw(h, w, m.norm_fn, m.conv1.stride[0])
                         for m in trunk] for h, w in buckets}
    if not all(all(v) for v in gate.values()):
        fails.append(f"(c) K3's gate refuses a chaos bucket: {gate}")
    jobs = [("mode", chaos.make_spec(s), f"mode_{s}", False) for s in CHAOS_MODE_SEEDS]
    jobs.append(("violate", chaos.make_spec(CHAOS_VIOLATE_SEED), "violate", True))
    for seed in CHAOS_PACKED_SEEDS:
        spec = dict(chaos.make_spec(seed), forward=CHAOS_PACKED_FORWARD)
        if any(e["kind"] == "oom" for e in spec["schedule"]):
            raise AssertionError(f"chaos_path: seed {seed} arms oom")
        jobs.append(("realtime_packed", spec, f"packed_{seed}", False))
    with ThreadPoolExecutor(max_workers=CHAOS_LANES) as pool:
        runs = [pool.submit(_chaos_trial, base / d, spec, label, violate)
                for label, spec, d, violate in jobs]
        results = [f.result() for f in runs]
    modes, packed, violate = [], [], None
    launches = {"alt_corr": 0, "fused_update": 0, "packed_conv": 0}
    for (label, spec, _, _), r in zip(jobs, results):
        if label == "mode":
            modes.append(r["line"])
            if not r["pass"]:
                fails.append(f"(a) seed {spec['seed']} ({spec['mode']})")
        elif label == "violate":
            violate = r["line"]
            if not r["pass"]:
                fails.append("(b) the planted violation was not caught")
        else:
            child = r["report"].get("launches") or {}
            got = {k: child.get("counted", {}).get(k, 0) + child.get("replayed", {}).get(k, 0)
                   for k in launches}
            for k, n in got.items():
                launches[k] += n
            bits = _chaos_bitwise(r["report"])
            detail = {"phase": "chaos_packed", "seed": spec["seed"], "launches": got,
                      "outputs": bits, "engines": r["report"].get("engines") or []}
            emit(detail)
            packed.append({**r["line"], **detail})
            if not r["pass"] or got["alt_corr"] < 1 or got["packed_conv"] < 1 \
                    or not bits["compared"] or bits["bitwise_equal"] != bits["compared"]:
                fails.append(f"(c) seed {spec['seed']}")
    res = {"phase": "chaos_path", "entry": "raft_stereo_tpu_torch.tools.chaos.run_trial",
           "lanes": CHAOS_LANES, "modes": modes, "violate": violate, "packed": packed,
           "packed_forward": CHAOS_PACKED_FORWARD, "packed_shapes": chaos.SHAPES,
           "k3_gate": gate, "launches": launches,
           "trial_s_sum": sum(r["line"]["wall_s"] for r in results),
           "seconds": time.perf_counter() - t_phase, "card": smi_line()}
    emit({k: v for k, v in res.items() if k not in ("modes", "packed")})
    if fails:
        raise AssertionError(f"chaos_path: {fails}")
    return res


# The kernels each main path must launch.
PATH_KERNELS = {
    "main_path": ("alt_corr",),
    "main_path_fused": ("alt_corr", "fused_update"),
    "main_path_realtime": ("alt_corr",),
    "main_path_realtime_packed": ("alt_corr", "packed_conv"),
    "engine_path": ("alt_corr",),
    "engine_path_fused": ("alt_corr", "fused_update"),
    "engine_path_realtime_packed": ("alt_corr", "packed_conv"),
    "train_path": (),
    "train_path_alt": ("alt_corr",),
    # the torchrun child's loop (its counters, from its log)
    "ddp_path": ("alt_corr",),
    "engine_faults_degraded": ("alt_corr", "packed_conv"),
    "train_grad_check_k2": ("fused_update",),
    "sched_path": ("alt_corr",),
    "sched_lifecycle": ("alt_corr", "packed_conv"),
    "video_path": ("alt_corr", "packed_conv"),
    "video_path_captured": ("alt_corr", "packed_conv"),
    "update_variables": ("alt_corr", "packed_conv"),
    # the MADNet2 family runs none of K1-K3 (each phase checks 0 launches)
    "mad_eval": (),
    "mad_parity": (),
    "mad_adapt_serve": (),
    "mad_train": (),
    # the serving composition: K1 in the RAFT-Stereo tiers; the controller
    # path's tiers are MADNet2 and the reg-lookup raftstereo (0 launches)
    "tier_path": ("alt_corr",),
    "cascade_path": ("alt_corr",),
    "iter_tiers_path": ("alt_corr",),
    "controller_path": (),
    # the fleet's workers are other processes: their counters are not read
    # here (MADNet2 runs none of K1-K3)
    "fleet_path": (),
    # K1 on every lookup of every shard, K2 a shard in the fused variant,
    # K3 on every slab of the packed stage
    "spatial_path": ("alt_corr", "fused_update", "packed_conv"),
    # the evaluate child's second (prewarmed) run, read from its log
    "aot_path": ("alt_corr",),
    # the realtime packed trials' children (their reports)
    "chaos_path": ("alt_corr", "packed_conv"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import raft_stereo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    checks = phase_kernel_check()
    fused_checks = phase_fused_check()
    stage1_checks = phase_k2_stage1_check()
    stage7_checks = phase_k2_stage7_check()
    k3_checks = phase_packed_conv_check()
    fused_checks[0]["by_launch"] = phase_k2_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = [
            phase_main_path(Path(tmp)),
            phase_main_path(Path(tmp), fused=True),
            phase_main_path(Path(tmp), iters=7, preset="raftstereo-realtime"),
            phase_main_path(Path(tmp), iters=7, preset="raftstereo-realtime", packed=True),
        ]
        phase_captured_forward(Path(tmp))
        paths += [
            phase_engine_path(Path(tmp)),
            phase_engine_path(Path(tmp), fused=True),
            phase_engine_path(Path(tmp), preset="raftstereo-realtime", iters=7, packed=True),
        ]
        phase_evaluate_eth3d(Path(tmp))
        paths += phase_engine_faults(Path(tmp))[1]
        phase_engine_oom_real(Path(tmp))
        phase_telemetry_cost(Path(tmp))
        phase_parity(Path(tmp))
        dnorms = phase_parity_fused(Path(tmp))
        phase_early_exit(Path(tmp), dnorms)
        phase_parity_packed(Path(tmp))
        grad_check, k2_grad_path = phase_train_grad_check()
        paths.append(k2_grad_path)
        phase_train_step_check()
        paths.append(phase_train_path(Path(tmp)))
        alt = phase_train_path(Path(tmp), corr="alt", steps=4)
        paths.append(alt)
        phase_train_resume(Path(tmp))
        paths.append(phase_ddp_path(Path(tmp), alt))
        phase_telemetry_runs(Path(tmp))
        t_serving = time.perf_counter()
        paths.append(phase_sched_path(Path(tmp)))
        paths.append(phase_sched_lifecycle(Path(tmp)))
        video = phase_video_path(Path(tmp))
        paths += [video, {"phase": "video_path_captured", "launches": video["captured_launches"]}]
        paths.append(phase_update_variables(Path(tmp)))
        phase_quality_canary(Path(tmp))
        phase_blackbox(Path(tmp))
        emit({"phase": "serving_total", "seconds": time.perf_counter() - t_serving})
        t_mad = time.perf_counter()
        paths += [phase_mad_eval(Path(tmp)), phase_mad_parity(Path(tmp)),
                  phase_mad_adapt_serve(Path(tmp)), phase_mad_train(Path(tmp))]
        emit({"phase": "mad_total", "seconds": time.perf_counter() - t_mad})
        t_comp = time.perf_counter()
        tier = phase_tier_path(Path(tmp))
        paths += [tier, phase_cascade_path(Path(tmp)),
                  phase_iter_tiers_path(Path(tmp), tier["untiered"]),
                  phase_controller_path(Path(tmp))]
        emit({"phase": "composition_total", "seconds": time.perf_counter() - t_comp})
        paths.append(phase_spatial_path(Path(tmp)))
        paths.append(phase_aot_path(Path(tmp)))
        paths.append(phase_fleet_path(Path(tmp)))
        paths.append(phase_chaos_path(Path(tmp)))
    # every phase's counters were read here but the fleet's (its workers')
    uncounted = [r["phase"] for r in paths if not isinstance(r["launches"], dict)]
    if uncounted != ["fleet_path"]:
        raise AssertionError(f"phases without launch counts: {uncounted}")
    by_path = {r["phase"]: r["launches"] for r in paths if r["phase"] != "fleet_path"}
    for path, counts in by_path.items():
        if any(counts[k] < 1 for k in PATH_KERNELS[path]):
            raise AssertionError(f"{path}: a kernel of the path never launched: {counts}")
    main_res, fused_res = paths[0], paths[1]
    k1_bwd = grad_check["k1"]
    alt_prof = next(r for r in paths if r["phase"] == "train_path_alt")["profiled_step"]
    # the main paths' shapes (K2, K3: bf16, the presets' dtype)
    k1, k2, k3 = checks[0], fused_checks[0], k3_checks[0]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "card": dev["smi"]})
    emit({"kernels": [
        {
            "name": "alt_corr", "route": "cuda",
            "source": "raft_stereo_tpu_torch/csrc/alt_corr.cu",
            "replaces": "raft_stereo_tpu/ops/pallas_corr.py:67",
            "launches": main_res["launches"]["alt_corr"],
            "launches_by_path": {p: c["alt_corr"] for p, c in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in checks), "tol": ALT_TOL,
            "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": None, "checks": checks,
            "backward": {
                "route": "plain recompute, a level at a time (ops/alt_corr.py::alt_lookup_vjp)",
                "shape": k1_bwd["shape"], "ms": k1_bwd["bwd_ms"],
                "bound_ms": k1_bwd["bwd_bound_ms"], "bound_by": k1_bwd["bwd_bound_by"],
                "forward_ms_at_that_shape": k1_bwd["fwd_ms"],
                "train_step_profile": alt_prof,
            },
        },
        {
            "name": "fused_update", "route": "cuda",
            "source": "raft_stereo_tpu_torch/csrc/fused_update.cu",
            "replaces": "raft_stereo_tpu/ops/pallas_fused_update.py:137",
            "launches": fused_res["launches"]["fused_update"],
            "launches_by_path": {p: c["fused_update"] for p, c in by_path.items()},
            "max_abs_err": max(max(c["err_h"], c["err_delta"]) for c in fused_checks),
            "tol": {c["case"]: {"h": c["tol_h"], "delta": c["tol_delta"],
                                **({"h_share": c["tol_h_share"]} if "h_share" in c else {})}
                    for c in fused_checks},
            "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"], "library_ms": None,
            "unfused_port_step_ms": k2["unfused_port_step_ms"],
            "launch_ms": {n: v["ms"] for n, v in k2["by_launch"]["launches"].items()},
            "conv_bound_ms": {c[0]: k2["by_launch"]["launches"][c[0]]["bound_ms"]
                              for c in K2_CONVS},
            "conv_library_ms": {c[0]: k2["by_launch"]["launches"][c[0]]["library_ms"]
                                for c in K2_CONVS},
            "checks": fused_checks,
            "stage1": {
                "entry": "raft_stereo_tpu_torch/ops/fused_update.py::motion_in",
                "launch": k2["by_launch"]["launches"]["motion_in (lookup, convc1, convf1)"],
                "tol": {"float32": f"{K2_STAGE1_FP32_TOL} x max(1, |plain| max)",
                        "bfloat16": K2_STAGE1_BF16_TOL},
                "checks": stage1_checks,
            },
            "stage7": {
                "entry": "raft_stereo_tpu_torch/ops/fused_update.py::head_out",
                "launch": k2["by_launch"]["launches"]["head_out (flow head conv2)"],
                "tol": f"{K2_STAGE7_TOL['sum_eps']} x 2^-24 x S (S: the conv of |fh1| with "
                       "|kfh2|, plus |bfh2|)",
                "checks": stage7_checks,
            },
            "backward": {
                "route": "plain autograd recompute (ops/fused_update.py::fused_step_vjp)",
                "shape": grad_check["k2"][0]["shape"],
                "ms": {c["dtype"]: c.get("bwd_ms") for c in grad_check["k2"]},
                "forward_ms_at_that_shape": {c["dtype"]: c.get("fwd_ms")
                                             for c in grad_check["k2"]},
                "determinism_needed": {c["dtype"]: c["determinism_needed"]
                                       for c in grad_check["k2"]},
            },
        },
        {
            "name": "packed_conv", "route": "cuda",
            "source": "raft_stereo_tpu_torch/csrc/packed_conv.cu",
            "replaces": "raft_stereo_tpu/experiments/pallas_packed_conv.py:46",
            "launches": by_path["main_path_realtime_packed"]["packed_conv"],
            "launches_by_path": {p: c["packed_conv"] for p, c in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in k3_checks),
            "tol": {"float32": f"{K3_FP32_TOL} x max(1, |plain| max)", "bfloat16": K3_BF16_TOL},
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
            "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
            "library_call": k3["library_call"], "checks": k3_checks,
            "backward": {
                "route": "plain autograd (experiments/packed_conv.py::packed_conv_vjp)",
                "shape": grad_check["k3"][0]["shape"],
                "ms": {c["dtype"]: c["bwd_plain_ms"] for c in grad_check["k3"]},
                "forward_ms_at_that_shape": {c["dtype"]: c["fwd_ms"] for c in grad_check["k3"]},
            },
        },
    ]})
    print(dev["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


def spatial_main() -> int:
    """``python3 chip_smoke.py spatial``: the device, the build, K1's checks
    and ``spatial_path`` alone (a quick check of the spatial tier; no
    ``ok`` line)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import raft_stereo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_device()
    phase_build()
    phase_kernel_check()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        res = phase_spatial_path(Path(tmp))
    if any(res["launches"][k] < 1 for k in PATH_KERNELS["spatial_path"]):
        raise AssertionError(f"spatial_path: a kernel of the path never launched: {res}")
    return 0


def chaos_main() -> int:
    """``python3 chip_smoke.py chaos``: the device, the build and
    ``chaos_path`` alone (a quick check of the campaign; no ``ok`` line)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import raft_stereo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        res = phase_chaos_path(Path(tmp))
    if any(res["launches"][k] < 1 for k in PATH_KERNELS["chaos_path"]):
        raise AssertionError(f"chaos_path: a kernel of the path never launched: {res}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["chaos"]:
        sys.exit(chaos_main())
    if sys.argv[1:2] == ["ddp-rank"]:
        sys.exit(ddp_rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["aot-child"]:
        sys.exit(aot_child_main(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["spatial"]:
        sys.exit(spatial_main())
    sys.exit(main())
