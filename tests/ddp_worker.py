"""One rank of a two-process gloo group on the CPU, for
tests/test_torch_port_ddp.py (no JAX here: the test process holds the
JAX side and hands this one numpy and torch files).

    python tests/ddp_worker.py steps RANK WORLD WORKDIR LABEL
    python tests/ddp_worker.py cli RANK WORLD WORKDIR LABEL -- ARGV...

The group meets through the file store ``WORKDIR/LABEL.store``, so
concurrent test workers never share a port.

``steps``: from ``WORKDIR/init.pt`` (the model's state_dict) and the global
batches ``WORKDIR/batches.npz``, the DDP train step of
``parallel/train_step.py`` on this rank's piece of each batch:

  * ``ddp``: two steps (batches 0 and 1); after each, this rank's metrics
    and a digest of every tensor of its train state, and (rank 0) the state;
  * ``guard``: one more step on batch 2 with NaN in rank 1's piece: whether
    the step was skipped and the state left bitwise unchanged; and
    ``apply_or_skip`` with a NaN loss on rank 1 alone (finite gradients);
  * ``naive``: from ``init.pt`` again, one step on batch 0 with the
    per-rank mean loss planted (``sequence_loss`` without ``distributed``);
    its metrics and (rank 0) state.

``cli``: ``train.main(ARGV + ["--multihost"], device="cpu")`` from WORKDIR;
the loop's result as JSON.

Each writes ``WORKDIR/LABEL_rank<r>.json`` (and ``.pt`` files).
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raft_stereo_tpu_torch import losses, train  # noqa: E402
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig  # noqa: E402
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo  # noqa: E402
from raft_stereo_tpu_torch.parallel import mesh  # noqa: E402
from raft_stereo_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state,
    make_train_step,
)
from raft_stereo_tpu_torch.runtime.guard import apply_or_skip  # noqa: E402
from raft_stereo_tpu_torch.utils.checkpoints import keyed_leaves  # noqa: E402

# the tiny configuration of tools/multihost_smoke.py
HIDDEN, N_GRU, ITERS = (64, 64, 64), 2, 2
TCFG = TrainConfig(num_steps=10, train_iters=ITERS)


def model_config() -> RAFTStereoConfig:
    return RAFTStereoConfig(hidden_dims=HIDDEN, n_gru_layers=N_GRU)


def fresh_state(workdir):
    model = RAFTStereo(model_config())
    model.load_state_dict(torch.load(os.path.join(workdir, "init.pt")), strict=True)
    return create_train_state(model.train(), TCFG)


def digest(state) -> dict:
    """sha256 of every tensor of the train state (bitwise equality across
    ranks)."""
    return {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
            for k, v in keyed_leaves(state.state_dict()).items()
            if isinstance(v, torch.Tensor)}


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def run_steps(workdir, rank):
    with np.load(os.path.join(workdir, "batches.npz")) as data:
        batches = [{k: torch.from_numpy(data[f"{i}_{k}"]) for k in
                    ("img1", "img2", "flow", "valid")} for i in range(3)]
    step = make_train_step(ITERS, nonfinite_guard=True, ddp=True)
    out = {"ddp": []}
    state = fresh_state(workdir)
    for i in (0, 1):
        state, metrics = step(state, mesh.shard_batch(batches[i]))
        out["ddp"].append({"metrics": floats(metrics), "digest": digest(state)})
        if rank == 0:
            torch.save(state.state_dict(), os.path.join(workdir, f"ddp_step{i + 1}.pt"))

    poisoned = mesh.shard_batch(batches[2])
    if rank == 1:
        poisoned = dict(poisoned, img1=torch.full_like(poisoned["img1"], float("nan")))
    before = digest(state)
    lr, position = state.lr, state.scheduler.last_epoch
    state, metrics = step(state, poisoned)
    out["guard"] = {"skipped": float(metrics["skipped"]), "unchanged": digest(state) == before,
                    "lr_and_schedule_unchanged": (state.lr, state.scheduler.last_epoch)
                    == (lr, position), "step": state.step,
                    # the skip decided on rank 1's loss alone, its gradients finite
                    "agreed": apply_or_skip(lambda: None,
                                            torch.tensor(float("nan") if rank else 1.0),
                                            [torch.ones(3)], distributed=True)}

    real = losses.sequence_loss

    def per_rank_mean(*args, distributed=False, **kwargs):
        return real(*args, **kwargs)

    losses.sequence_loss = per_rank_mean
    try:
        state, metrics = step(fresh_state(workdir), mesh.shard_batch(batches[0]))
    finally:
        losses.sequence_loss = real
    out["naive"] = {"metrics": floats(metrics)}
    if rank == 0:
        torch.save(state.state_dict(), os.path.join(workdir, "naive_step1.pt"))
    return out


def run_cli(workdir, argv):
    os.chdir(workdir)
    result = train.main(argv + ["--multihost"], device="cpu")
    return {"total_steps": result.total_steps, "preempted": result.preempted,
            "path": str(result.path), "stream_pos": result.stream_pos}


def main():
    mode, rank, world, workdir, label = sys.argv[1:6]
    rank, world = int(rank), int(world)
    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, label + ".store"),
                            rank=rank, world_size=world)
    try:
        out = run_steps(workdir, rank) if mode == "steps" else run_cli(workdir, argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(workdir, f"{label}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
