from raft_stereo_tpu_torch.parallel.mesh import (
    all_ranks,
    all_sum,
    any_rank,
    barrier,
    broadcast_object,
    destroy,
    fetch_to_host,
    init_distributed,
    rank,
    replicate,
    shard_batch,
    world,
)

__all__ = [
    "all_ranks",
    "all_sum",
    "any_rank",
    "barrier",
    "broadcast_object",
    "destroy",
    "fetch_to_host",
    "init_distributed",
    "rank",
    "replicate",
    "shard_batch",
    "world",
]
