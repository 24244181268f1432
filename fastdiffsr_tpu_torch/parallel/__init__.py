from .mesh import RowGenerator, auto_world, rand_rows, rank_rows, sample_rows
from .multihost import (all_reduce_mean, all_reduce_sum, average_gradients,
                        barrier, broadcast_from_main, broadcast_object,
                        data_parallel, initialize_from_env, is_main,
                        local_batch, rank, sample_group, shutdown,
                        world_size)

__all__ = ["RowGenerator", "auto_world", "rand_rows", "rank_rows",
           "sample_rows", "all_reduce_mean", "all_reduce_sum",
           "average_gradients", "barrier", "broadcast_from_main",
           "broadcast_object", "data_parallel", "initialize_from_env",
           "is_main", "local_batch", "rank", "sample_group", "shutdown",
           "world_size"]
