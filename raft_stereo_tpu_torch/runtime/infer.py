"""Batched inference engine, with each forward captured once per (bucket,
batch) as a CUDA graph (PyTorch port of the plain engine of
``raft_stereo_tpu/runtime/infer.py``).

  * **Shape buckets.** Pairs are grouped by their /32-padded shape
    (``ops.pad.bucket_shape``). Each member of a bucket is edge-padded with
    its own offsets, the bytes the per-image ``InputPadder`` gives it, so
    one captured forward serves the bucket and results unpad per item.
  * **Fixed micro-batches.** A bucket packs into micro-batches of exactly
    ``batch`` items. A partial batch is filled up by replicating its last
    item and carries a validity count, so the filler never surfaces and the
    batch runs the same graph as a full one.
  * **One captured forward per (bucket, batch)** in a ``GraphCache``, the
    counterpart of the JAX package's ``AOTCache``: on the first batch of a
    key the forward runs once eagerly (which builds the kernels and settles
    every lazy choice), is captured into a ``torch.cuda.CUDAGraph``, and
    every batch of the key then replays it. On the CPU, or with
    ``capture=False``, each batch runs the forward eagerly.
  * **A stager thread** decodes (a request's lazy ``inputs`` callable),
    accounts buckets, pads and stacks batch N+1 on the host while batch N
    computes, behind a queue of ``prefetch_depth`` batches. It touches no
    CUDA state: a capture in global mode on the dispatch thread cannot be
    broken by it. The dispatch thread pins the stacked inputs, copies them
    to the card on its own stream, replays, and copies the output into
    pinned host memory on the same stream; it keeps one dispatch in flight,
    so the host work on batch N's results overlaps batch N+1's compute.

Failures stay with their requests: a decode, validation or staging error,
or a failed forward (a kernel launch that raises, during warm-up, capture
or replay), becomes an ``InferResult`` whose ``error`` is set, and the
stream goes on. Nothing falls back to another path. The stager puts its
end-of-stream sentinel in ``finally``, and with ``deadline_s`` a stager that
stages nothing for that long fails the stream with ``InferStallError``.

Results stream in micro-batch completion order: buckets interleave, and
within a batch the request order is kept. Each result carries its request's
``payload``.

Kernel launches. The kernels' ``LAUNCHES`` counters count wrapper calls,
so a replay does not move them: they count the warm-up's launches and the
capture's. ``GraphCache`` records each graph's launches at capture and
sums, over replays, the launches the card ran (``replayed_launches``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.experiments import packed_conv
from raft_stereo_tpu_torch.ops import alt_corr, fused_update
from raft_stereo_tpu_torch.ops.pad import BatchPadder, bucket_shape

logger = logging.getLogger(__name__)

_END = object()  # stager sentinel: the request stream is exhausted

# A batch that waited on the stager longer than this is an underrun: the
# host failed to hide decode, padding and stacking behind device compute.
STAGER_UNDERRUN_S = 0.05


class InferStallError(RuntimeError):
    """The stager staged nothing within the deadline: ``stream()`` fails
    instead of blocking its consumer."""


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e)[:200]}"


def kernel_launches() -> Dict[str, int]:
    """The port's kernel launch counters, by kernel."""
    return {"alt_corr": alt_corr.LAUNCHES, "fused_update": fused_update.LAUNCHES,
            "packed_conv": packed_conv.LAUNCHES}


# ------------------------------------------------------------ graph cache


@dataclass
class CapturedForward:
    """One forward captured at fixed input shapes: the graph, its static
    input and output buffers, and the kernel launches it holds."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor
    launches: Dict[str, int]
    replays: int = 0


class GraphCache:
    """LRU of captured forwards, at most ``max_entries``, keyed by the caller
    (the engine: bucket shape, batch, input dtypes, iterations and model).

    Every graph draws from one shared memory pool: each capture reuses the
    memory earlier graphs free after their own captures, so sixteen graphs
    of large activations do not each hold their own. That is safe because
    replays run one at a time on one stream, and the caller copies
    each output out on that stream before the next replay, which may write
    over it. Static inputs live outside the pool. Eviction drops the graph
    and its buffers.

    ``get`` warms up and captures on the first call of a key; ``replay``
    runs a captured forward. Counters: ``captures``, ``capture_s`` (warm-up
    included), ``hits`` (a ``get`` that found its key), ``replays``,
    ``evictions``, and ``replayed_launches``: each kernel's launches at
    capture, summed over replays.
    """

    def __init__(self, max_entries: int = 16):
        if max_entries < 1:
            raise ValueError("GraphCache max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[Hashable, CapturedForward]" = OrderedDict()
        self._pool = None
        self.captures = 0
        self.capture_s = 0.0
        self.hits = 0
        self.replays = 0
        self.evictions = 0
        self.replayed_launches = {k: 0 for k in kernel_launches()}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def entry(self, key) -> CapturedForward:
        return self._entries[key]

    def items(self):
        """(key, captured forward) pairs, least recently used first."""
        return self._entries.items()

    def get(self, key, fn: Callable[..., torch.Tensor],
            inputs: Tuple[torch.Tensor, ...]) -> CapturedForward:
        """The key's captured forward, captured first from ``fn`` at the
        shapes of ``inputs`` (host or device tensors) if the key is new."""
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        entry = self._entries[key] = self._capture(fn, inputs)
        if len(self._entries) > self.max_entries:
            old_key, old = self._entries.popitem(last=False)
            old.graph.reset()
            self.evictions += 1
            logger.info("GraphCache: evicted the graph of %s", old_key)
        return entry

    def replay(self, entry: CapturedForward, inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """Copy ``inputs`` into the entry's static inputs and replay it, on
        the current stream. The returned static output is valid until the
        next replay of any graph of this cache."""
        for dst, src in zip(entry.inputs, inputs):
            dst.copy_(src, non_blocking=True)
        entry.graph.replay()
        entry.replays += 1
        self.replays += 1
        for k, n in entry.launches.items():
            self.replayed_launches[k] += n
        return entry.output

    def run(self, key, fn: Callable[..., torch.Tensor],
            inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """``fn(*inputs)`` through the key's graph (``get``, then ``replay``)."""
        return self.replay(self.get(key, fn, inputs), inputs)

    def _capture(self, fn, inputs) -> CapturedForward:
        """Warm up eagerly on a side stream, then capture on the pool. The
        warm-up builds the kernels' libraries, sets their shared-memory
        attributes and settles cuDNN's choices, so the capture itself
        builds, allocates outside the pool and reads back nothing."""
        t0 = time.perf_counter()
        dev = torch.device("cuda", torch.cuda.current_device())
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs)
        for dst, src in zip(static, inputs):
            dst.copy_(src, non_blocking=True)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        with torch.cuda.graph(graph, pool=self._pool):
            output = fn(*static)
        launches = {k: n - before[k] for k, n in kernel_launches().items()}
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return CapturedForward(graph, static, output, launches)


# ------------------------------------------------------ requests, results


@dataclass
class InferRequest:
    """One inference item: ``inputs`` are [H, W, C] host arrays sharing one
    (H, W) (the image pair), or a zero-argument callable that returns them
    (the lazy decode form: it runs on the stager thread, and what it raises
    fails this request alone). ``payload`` is carried onto the result."""

    payload: Any
    inputs: Any  # Tuple[np.ndarray, ...] | Callable[[], Tuple[np.ndarray, ...]]

    def resolve(self) -> Tuple[np.ndarray, ...]:
        """Materialise and validate the input arrays (stager thread)."""
        raw = self.inputs() if callable(self.inputs) else self.inputs
        arrays = tuple(np.asarray(x) for x in raw)
        if not arrays:
            raise ValueError(f"request {self.payload!r} has no inputs")
        for a in arrays:
            if a.ndim != 3:
                raise ValueError(
                    f"request {self.payload!r}: expected [H, W, C] inputs, got shape {a.shape}")
        h, w = arrays[0].shape[:2]
        for k, a in enumerate(arrays[1:], start=1):
            if a.shape[:2] != (h, w):
                raise ValueError(
                    f"request {self.payload!r}: input slot {k} is {a.shape[:2]}, slot 0 is "
                    f"{(h, w)}; all slots must share one (H, W)")
        return arrays


@dataclass
class FlushRequest:
    """In-band control token: stage ``bucket``'s partial batch now (padded
    and masked, on the full batch's graph) instead of at the end of the
    stream; ``None`` flushes every pending bucket in sorted order. It
    produces no result."""

    bucket: Optional[Tuple[int, int]] = None


@dataclass
class InferResult:
    """On success ``output`` is the item's original [H, W, C'] window of the
    batched output (host numpy). On failure ``error`` holds the exception,
    ``output`` is None, and ``bucket`` is None for a failed decode."""

    payload: Any
    output: Optional[np.ndarray] = None
    bucket: Optional[Tuple[int, int]] = None
    error: Optional[BaseException] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class _FailedRequest:
    """Stager → consumer: a request that failed before dispatch."""

    payload: Any
    error: BaseException


@dataclass
class _StagedBatch:
    bucket: Tuple[int, int]
    payloads: List[Any]
    padder: BatchPadder
    arrays: Tuple[np.ndarray, ...]  # host [B, Hb, Wb, C] per input slot
    valid: int
    stage_s: float


@dataclass
class InferStats:
    """Time and volume accounting of an engine (seconds unless named)."""

    images: int = 0          # requests that yielded a result
    failed: int = 0          # requests that yielded an error result
    batches: int = 0
    padded_slots: int = 0
    decode_wait_s: float = 0.0  # consumer blocked on the stager queue
    h2d_stage_s: float = 0.0    # stager: pad + stack (host)
    device_batch_s: float = 0.0  # consumer blocked on device results
    stream_s: float = 0.0       # wall time inside stream(), captures included
    underruns: int = 0
    buckets: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # each batch's device time on CUDA (ms, by CUDA events from the input
    # copy to the end of the output copy) and its valid items
    batch_ms: List[float] = field(default_factory=list)
    batch_valid: List[int] = field(default_factory=list)

    def breakdown_ms(self) -> Dict[str, float]:
        """Per-batch means of the host-side waits."""
        n = max(self.batches, 1)
        return {
            "decode_wait_ms": round(self.decode_wait_s / n * 1e3, 3),
            "h2d_stage_ms": round(self.h2d_stage_s / n * 1e3, 3),
            "device_batch_ms": round(self.device_batch_s / n * 1e3, 3),
        }


@dataclass(frozen=True)
class StreamSummary:
    """Completed against failed requests of one serving run."""

    completed: int
    failed: int

    @property
    def total(self) -> int:
        return self.completed + self.failed

    @property
    def failed_frac(self) -> float:
        return self.failed / self.total if self.total else 0.0


# The last published summary: the validators own the engine, the CLI mains
# own the exit code, and this is the one-way channel between them. The
# mains reset it on entry.
_last_summary: Optional[StreamSummary] = None


def publish_summary(stats: InferStats, label: str = "serving") -> StreamSummary:
    """Derive, print and record the run's completed/failed summary."""
    global _last_summary
    s = StreamSummary(completed=stats.images, failed=stats.failed)
    _last_summary = s
    print(f"[{label}] requests: {s.completed}/{s.total} completed, {s.failed} failed")
    return s


def last_summary() -> Optional[StreamSummary]:
    return _last_summary


def reset_summary() -> None:
    global _last_summary
    _last_summary = None


def enforce_failure_budget(max_failed_frac: float) -> None:
    """``SystemExit`` when the published failed fraction exceeds the budget
    (0 by default: any failure fails the run). Nothing published (the
    per-image path) means nothing to enforce."""
    s = _last_summary
    if s is None or s.failed == 0:
        return
    if s.failed_frac > max_failed_frac:
        raise SystemExit(
            f"[serving] {s.failed}/{s.total} requests failed (fraction "
            f"{s.failed_frac:.3f} > --max_failed_frac {max_failed_frac:g})")


# ----------------------------------------------------------------- engine


@dataclass
class _Dispatched:
    staged: _StagedBatch
    host: Optional[torch.Tensor] = None  # the batch's output on the host
    done: Any = None  # torch.cuda.Event recorded after the output copy
    start: Any = None  # torch.cuda.Event recorded before the input copy
    error: Optional[BaseException] = None


class InferenceEngine:
    """Batched, pipelined inference over pairs of any shape.

    ``forward_fn(*inputs) -> [B, Hb, Wb, C']`` is the model forward on
    device tensors (inputs mirror ``InferRequest.inputs``, stacked and
    padded). On ``device`` CUDA with ``capture`` (the default), each
    (bucket, batch) runs as one CUDA graph from a ``GraphCache`` of
    ``max_executables`` entries; ``graph_key`` names what else the graph
    bakes in (the model and its iterations). Otherwise every batch runs
    ``forward_fn`` eagerly; the model's ``converge_eps`` exit, which reads a
    scalar back each step, must run so (``evaluate.make_engine`` passes
    ``capture=False`` for it). ``stream(requests)`` yields ``InferResult``s,
    error results included (check ``result.ok``).
    """

    def __init__(self, forward_fn: Callable[..., torch.Tensor], *, device,
                 batch: int = 4, prefetch_depth: int = 2, max_executables: int = 16,
                 deadline_s: Optional[float] = None, capture: bool = True,
                 graph_key: Tuple = ()):
        if batch < 1:
            raise ValueError("InferenceEngine batch must be >= 1")
        if prefetch_depth < 1:
            raise ValueError("InferenceEngine prefetch_depth must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("InferenceEngine deadline_s must be > 0 or None")
        self.forward_fn = forward_fn
        self.device = torch.device(device)
        self.batch = int(batch)
        self.prefetch_depth = int(prefetch_depth)
        self.deadline_s = deadline_s
        self.capture = bool(capture) and self.device.type == "cuda"
        self.graph_key = tuple(graph_key)
        self.graphs = GraphCache(max_executables)
        self.stats = InferStats()

    # ----------------------------------------------------------- stager

    def _stage(self, items: List[Tuple[Any, Tuple[np.ndarray, ...]]], bucket) -> _StagedBatch:
        """Pack one bucket's items into a fixed micro-batch on the host."""
        valid = len(items)
        items = items + [items[-1]] * (self.batch - valid)  # filler, masked by ``valid``
        t0 = time.perf_counter()
        padder = BatchPadder([x[1][0].shape[:2] for x in items])
        arrays = tuple(padder.pad([x[1][k] for x in items]) for k in range(len(items[0][1])))
        return _StagedBatch(bucket=bucket, payloads=[x[0] for x in items[:valid]],
                            padder=padder, arrays=arrays, valid=valid,
                            stage_s=time.perf_counter() - t0)

    def _stage_put(self, put, items, bucket) -> bool:
        """Stage one micro-batch; a staging failure fails its requests only."""
        try:
            staged = self._stage(items, bucket)
        except Exception as e:  # noqa: BLE001 — isolated to the batch
            logger.warning("staging bucket %s failed (%s): failing its %d request(s)",
                           bucket, _errstr(e), len(items))
            return all(put(_FailedRequest(payload, e)) for payload, _ in items)
        return put(staged)

    def _stager_run(self, requests: Iterable, q: "queue.Queue", stop: threading.Event) -> None:
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            acc: Dict[Tuple[int, int], list] = {}
            it = iter(requests)
            while not stop.is_set():
                try:
                    req = next(it)
                except StopIteration:
                    break
                if isinstance(req, FlushRequest):
                    for b in [req.bucket] if req.bucket is not None else sorted(acc):
                        items = acc.pop(b, None)
                        if items and not self._stage_put(put, items, b):
                            return
                    continue
                try:
                    arrays = req.resolve()  # the lazy decode runs here
                    bucket = bucket_shape(*arrays[0].shape[:2])
                except Exception as e:  # noqa: BLE001 — isolated to the request
                    if not put(_FailedRequest(req.payload, e)):
                        return
                    continue
                acc.setdefault(bucket, []).append((req.payload, arrays))
                if len(acc[bucket]) == self.batch:
                    if not self._stage_put(put, acc.pop(bucket), bucket):
                        return
            for bucket in sorted(acc):  # partial buckets, in a fixed order
                if not self._stage_put(put, acc.pop(bucket), bucket):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)
        finally:
            # on every exit path: a consumer never waits on a dead stager
            put(_END)

    # ----------------------------------------------------------- stream

    def stream(self, requests: Iterable) -> Iterator[InferResult]:
        """Run the engine over ``requests`` (``InferRequest``s and
        ``FlushRequest``s); yield unpadded results. One stream at a time per
        engine; the graphs and stats persist across streams.

        A failed request or batch yields error results and the stream goes
        on; the request iterable raising, or a stager that stages nothing
        within ``deadline_s`` (``InferStallError``), fails the stream."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        thread = threading.Thread(target=self._stager_run, args=(requests, q, stop),
                                  name="infer-stager", daemon=True)
        thread.start()
        pending: Optional[_Dispatched] = None
        stalled = False
        t_stream = time.perf_counter()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = q.get() if self.deadline_s is None else q.get(timeout=self.deadline_s)
                except queue.Empty:
                    stalled = True
                    raise InferStallError(
                        f"stager staged nothing for {self.deadline_s:g}s (--infer_timeout); "
                        f"stager thread alive={thread.is_alive()}, {self.stats.batches} "
                        f"batch(es) done") from None
                wait_s = time.perf_counter() - t0
                if isinstance(item, BaseException):
                    raise item
                if item is _END:
                    break
                if isinstance(item, _FailedRequest):
                    self.stats.failed += 1
                    logger.warning("request %r failed before dispatch: %s", item.payload,
                                   _errstr(item.error))
                    yield InferResult(payload=item.payload, error=item.error)
                    continue
                self.stats.decode_wait_s += wait_s
                if self.stats.batches > 0 and wait_s > STAGER_UNDERRUN_S:
                    self.stats.underruns += 1
                dispatched = self._dispatch(item)
                self._account(item)
                if pending is not None:
                    yield from self._finalize(pending)
                pending = dispatched
            if pending is not None:
                yield from self._finalize(pending)
                pending = None
        finally:
            stop.set()
            while True:  # unblock a stager stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # a stager already declared stalled is abandoned (daemon thread)
            thread.join(timeout=0.1 if stalled else 5.0)
            self.stats.stream_s += time.perf_counter() - t_stream

    def _dispatch(self, staged: _StagedBatch) -> _Dispatched:
        """Launch one staged batch; a failure is kept for ``_finalize``."""
        d = _Dispatched(staged)
        try:
            if self.device.type != "cuda":
                inputs = tuple(torch.from_numpy(a).to(self.device) for a in staged.arrays)
                d.host = self.forward_fn(*inputs).detach()
                return d
            inputs = tuple(torch.from_numpy(a).pin_memory() for a in staged.arrays)
            if self.capture:
                key = (staged.bucket, self.batch,
                       *((tuple(a.shape), str(a.dtype)) for a in staged.arrays), *self.graph_key)
                entry = self.graphs.get(key, self.forward_fn, inputs)
                d.start = torch.cuda.Event(enable_timing=True)
                d.start.record()
                out = self.graphs.replay(entry, inputs)
            else:
                d.start = torch.cuda.Event(enable_timing=True)
                d.start.record()
                out = self.forward_fn(*(x.to(self.device, non_blocking=True) for x in inputs))
            # the static output is overwritten by the next replay: copy it
            # out on the stream now
            d.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            d.host.copy_(out, non_blocking=True)
            d.done = torch.cuda.Event(enable_timing=True)
            d.done.record()
        except Exception as e:  # noqa: BLE001 — fails the batch, not the stream
            d.error = e
        return d

    def _account(self, staged: _StagedBatch) -> None:
        self.stats.batches += 1
        self.stats.padded_slots += self.batch - staged.valid
        self.stats.h2d_stage_s += staged.stage_s
        self.stats.buckets[staged.bucket] = self.stats.buckets.get(staged.bucket, 0) + staged.valid

    def _finalize(self, d: _Dispatched) -> Iterator[InferResult]:
        staged = d.staged
        t0 = time.perf_counter()
        if d.error is None and d.done is not None:
            try:
                d.done.synchronize()
                self.stats.batch_ms.append(d.start.elapsed_time(d.done))
                self.stats.batch_valid.append(staged.valid)
            except Exception as e:  # noqa: BLE001 — fails the batch, not the stream
                d.error = e
        if d.error is not None:
            logger.error("batch of %d request(s) in bucket %s failed: %s", staged.valid,
                         staged.bucket, _errstr(d.error))
            for payload in staged.payloads:
                self.stats.failed += 1
                yield InferResult(payload=payload, bucket=staged.bucket, error=d.error)
            return
        self.stats.device_batch_s += time.perf_counter() - t0
        host = d.host.numpy()
        for payload, window in zip(staged.payloads, staged.padder.unpad_all(host, staged.valid)):
            self.stats.images += 1
            yield InferResult(payload=payload, output=np.array(window), bucket=staged.bucket)


# ----------------------------------------------------------------- CLI glue


@dataclass(frozen=True)
class InferOptions:
    """The engine's options shared by evaluate and demo."""

    batch: int = 4
    prefetch: int = 2
    max_executables: int = 16
    deadline_s: Optional[float] = 300.0


def add_infer_args(parser, default_batch: int = 4) -> None:
    """Register the engine's flags."""
    parser.add_argument(
        "--infer_batch", type=int, default=default_batch,
        help="micro-batch size of the batched inference engine: inputs are grouped into "
        "/32-padded shape buckets and packed into fixed batches of this size (a partial "
        "batch is filled up and masked, so it runs the same captured graph)")
    parser.add_argument(
        "--per_image", action="store_true",
        help="bypass the engine: one pair per forward, synchronously (the reference "
        "protocol; KITTI's per-pair FPS is defined in this mode only)")
    parser.add_argument(
        "--infer_prefetch", type=int, default=2,
        help="staged-batch queue depth of the engine's decode/pad stager thread")
    parser.add_argument(
        "--infer_timeout", type=float, default=300.0, metavar="SECONDS",
        help="stager watchdog: a stager that stages nothing for this long fails the "
        "stream instead of hanging it; <= 0 disables it")
    parser.add_argument(
        "--max_failed_frac", type=float, default=0.0, metavar="FRAC",
        help="tolerated fraction of failed requests before the run exits non-zero "
        "(default 0: any failure fails the run); failed requests are always excluded "
        "from metrics and counted in the summary line")


def options_from_args(args) -> Optional[InferOptions]:
    """``None`` means the per-image path."""
    if args.per_image:
        return None
    timeout = args.infer_timeout
    return InferOptions(batch=args.infer_batch, prefetch=args.infer_prefetch,
                        deadline_s=None if timeout is None or timeout <= 0 else timeout)
