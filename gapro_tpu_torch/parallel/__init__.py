from .mesh import (DataParallelGroup, data_parallel_mesh, initialize_multihost,
                   process_allgather, replicate, shard_batch, spawn_ranks)

__all__ = [
    "DataParallelGroup",
    "data_parallel_mesh",
    "initialize_multihost",
    "process_allgather",
    "replicate",
    "shard_batch",
    "spawn_ranks",
]
