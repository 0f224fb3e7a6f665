"""Multi-device parallelism: mesh construction, data-parallel SPMD training
and sharded prediction."""

from .dp import dp_train_epoch, make_dp_epoch_fn, shard_dataset, shard_epoch_indices
from .infer_dp import make_dp_predict_fn
from .mesh import (
    data_sharding,
    initialize_distributed,
    local_shard_size,
    make_mesh,
    replicated,
    shard_leaves,
)

__all__ = [
    "dp_train_epoch",
    "make_dp_epoch_fn",
    "make_dp_predict_fn",
    "shard_dataset",
    "shard_epoch_indices",
    "data_sharding",
    "initialize_distributed",
    "local_shard_size",
    "make_mesh",
    "replicated",
    "shard_leaves",
]
