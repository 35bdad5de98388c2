"""The data axis across processes (the port's own copy of the data-axis
part of ``raft_stereo_tpu/parallel/mesh.py:30-157``): one process a card,
joined by ``torch.distributed``; and the spatial tier's device list
(``mesh.py:50-84,147-159``), which one process drives.

JAX shards a batch over a named mesh axis and XLA inserts the gradient
all-reduce; here each process (a *rank*) holds a full replica of the train
state and its own piece of the global batch, and
``DistributedDataParallel`` (``parallel/train_step.py``) averages the
gradients. The global batch is the ranks' pieces in rank order, as JAX's
``make_array_from_process_local_data`` assembles it across hosts.

  * ``init_distributed`` joins the process group torchrun describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on a card, gloo on the CPU, unless the caller
    names the backend; a caller that already made the group keeps it.
  * ``rank``/``world`` read the group (0 and 1 without one);
    ``shard_batch`` cuts a rank's piece out of a global batch;
    ``replicate`` broadcasts rank 0's tensors; ``fetch_to_host`` snapshots
    a tree on the host with overlapped copies.
  * ``all_sum``, ``any_rank``, ``all_ranks``, ``broadcast_object`` and
    ``barrier`` are the few collectives the loss, the guard, the loop and
    the checkpoints need; each is a no-op in one process.
  * ``spatial_mesh`` is the spatial tier's list of shard devices (the JAX
    mesh's ``spatial`` axis; no process group: one process drives every
    shard, as one JAX process drives its mesh), ``mesh_spatial_size`` its
    length and ``shard_spatial`` the row slabs of a [B, H, W, C] batch on
    them (``parallel/spatial.py`` holds the exchange between them).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from raft_stereo_tpu_torch.parallel import spatial


def init_distributed(device=None, backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``device`` None is the card ``cuda:LOCAL_RANK``, which must exist; a
    ``cuda`` device without an index gets that index too. The backend is
    NCCL for a card and gloo for the CPU unless ``backend`` names another
    (gloo lets two ranks share one card, which NCCL refuses)."""
    if device is None or torch.device(device) == torch.device("cuda"):
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            raise RuntimeError("init_distributed: LOCAL_RANK is not set; launch with torchrun "
                               "(python -m torch.distributed.run) or pass the device")
        if not torch.cuda.is_available() or int(local) >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_distributed: rank with LOCAL_RANK {local} has no card "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0} visible); "
                "pass device='cpu' to train on the CPU")
        dev = torch.device("cuda", int(local))
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"init_distributed: the process group runs {dist.get_backend()}, "
                               f"not {backend}")
    else:
        dist.init_process_group(backend, init_method="env://")
    return dev


def destroy() -> None:
    """Leave the process group (if there is one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a collective's tensor lives: the current card under NCCL, else
    the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(batch: Dict[str, Any], index: Optional[int] = None,
                count: Optional[int] = None) -> Dict[str, Any]:
    """Rank ``index``'s piece (this rank's by default) of a global batch of
    [B, ...] arrays split over ``count`` ranks (the world): rows
    [r·B/n, (r+1)·B/n), so the global batch is the pieces in rank order."""
    r = rank() if index is None else index
    n = world() if count is None else count
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"shard_batch: batch sizes {sorted(sizes)} do not split over {n} ranks")
    per = next(iter(sizes)) // n
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(tree):
    """Overwrite every tensor of ``tree`` (nested dicts and lists, e.g. a
    train state's ``state_dict()``, whose tensors share storage with the
    model and the optimizer) with rank 0's, in place; returns ``tree``."""
    if world() == 1:
        return tree
    dev = _collective_device()
    for t in _tensors(tree):
        if t.device == dev or dev.type == "cpu":
            dist.broadcast(t, 0)
        else:  # NCCL broadcasts card tensors only: a host tensor goes through one
            staged = t.to(dev)
            dist.broadcast(staged, 0)
            t.copy_(staged)
    return tree


def fetch_to_host(tree):
    """A host copy of ``tree``: every card tensor's copy is started into
    pinned memory first and waited for once, so the copies overlap."""
    started = []

    def fetch(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                out.copy_(x, non_blocking=True)
                started.append(x.device)
                return out
            return x.clone()
        if isinstance(x, dict):
            return {k: fetch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fetch(v) for v in x)
        return x

    out = fetch(tree)
    for d in set(started):
        torch.cuda.synchronize(d)
    return out


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (in place; ``t`` must not need a
    gradient)."""
    if world() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def any_rank(flag: bool) -> bool:
    """True on every rank if ``flag`` is true on any."""
    if world() == 1:
        return bool(flag)
    t = torch.tensor([float(bool(flag))], device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def all_ranks(flag: torch.Tensor) -> bool:
    """True on every rank if the scalar bool ``flag`` is true on all (it may
    stay on its device: under gloo a card tensor is reduced in place)."""
    if world() == 1:
        return bool(flag)
    t = (~flag.reshape(1)).float()
    if dist.get_backend() == "nccl":
        t = t.to(_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return not bool(t.item() > 0)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait until every rank is here."""
    if world() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def indexed_device(d) -> torch.device:
    """``d`` with an index where it is a card (``cuda`` is the current one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def spatial_mesh(num_spatial: int = 0, devices: Optional[Sequence] = None
                 ) -> List[torch.device]:
    """The spatial tier's shard devices. ``devices`` None is every visible
    card (``[cpu]`` without one); an explicit list may repeat a device
    (several slabs on one card, or on the CPU). ``num_spatial`` 0 takes
    them all; another count must divide their number (the JAX
    ``spatial_mesh``'s rule, which leaves the rest to its data axis; the
    spatial tier here has none, and takes the first ``num_spatial``)."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    devices = [indexed_device(d) for d in devices]
    k = len(devices) if num_spatial in (0, None) else int(num_spatial)
    if k < 1 or len(devices) % k != 0:
        raise ValueError(f"spatial_mesh: num_spatial={k} must be >= 1 and divide the "
                         f"device count ({len(devices)})")
    return devices[:k]


def mesh_spatial_size(devices: Optional[Sequence]) -> int:
    """How many shards a device list makes (1, no H sharding, for None)."""
    return 1 if not devices else len(devices)


def shard_spatial(devices: Sequence, x, unit: int) -> List[torch.Tensor]:
    """[B, H, W, C] (a tensor or an array) as row slabs in whole units of
    ``unit`` rows, one on each device that gets rows (``spatial.row_split``)."""
    x = torch.as_tensor(x)
    bounds = spatial.row_split(x.shape[1], unit, len(devices))
    return spatial.split(x, bounds, [indexed_device(d) for d in devices], dim=1)


__all__ = [
    "all_ranks",
    "all_sum",
    "any_rank",
    "barrier",
    "broadcast_object",
    "destroy",
    "fetch_to_host",
    "init_distributed",
    "mesh_spatial_size",
    "rank",
    "replicate",
    "shard_batch",
    "shard_spatial",
    "spatial_mesh",
    "world",
]
