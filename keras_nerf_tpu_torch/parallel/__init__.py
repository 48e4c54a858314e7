"""Distribution tier: data parallelism over ``torch.distributed``, one
process per card (port of ``keras_nerf_tpu/parallel``)."""

from keras_nerf_tpu_torch.parallel.data_parallel import (
    BatchSharding,
    Group,
    make_group,
    rank_seed,
    replicate,
    run_ranks,
    shard_batch,
    sharded_eval_step,
    sharded_render,
    sharded_render_occ,
    sharded_train_step,
    world_size,
)

__all__ = [
    "BatchSharding",
    "Group",
    "make_group",
    "rank_seed",
    "replicate",
    "run_ranks",
    "shard_batch",
    "sharded_eval_step",
    "sharded_render",
    "sharded_render_occ",
    "sharded_train_step",
    "world_size",
]
