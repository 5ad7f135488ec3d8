"""Parallelism: the process mesh, the tensor-parallel sharding rules and
distributed synthesis over ``torch.distributed`` (counterpart of
``gst_tacotron_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    place_tree,
    process_data_shard,
    replicate_tree,
    shard_batch,
)
from .sharding import (
    describe_sharding,
    param_shardings,
    place_state,
    shard_params,
    state_shardings,
)
from .distributed_synthesis import DistributedSynthesizer

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "replicate_tree",
    "shard_batch",
    "initialize_distributed",
    "param_shardings",
    "place_state",
    "place_tree",
    "process_data_shard",
    "shard_params",
    "state_shardings",
    "describe_sharding",
    "DistributedSynthesizer",
]
