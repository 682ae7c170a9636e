"""Data parallelism on `torch.distributed` (port of `infomax3d_tpu/
parallel/`'s ``n_shards`` mode): one process per shard, losses, BatchNorm
statistics and parameter updates equal to one process's on the
concatenated batch.  The edge- and node-partitioned modes and tensor
parallelism are ROADMAP queue 1, items 9b and 9c."""
from infomax3d_tpu_torch.parallel.collectives import (CrossDeviceLoss,
                                                      all_gather_rows,
                                                      all_reduce_sum,
                                                      mean_over_ranks)
from infomax3d_tpu_torch.parallel.context import (data_parallel_group,
                                                  using_data_parallel_group)
from infomax3d_tpu_torch.parallel.mesh import (close_group, local_devices,
                                               make_group, rank_devices)
from infomax3d_tpu_torch.parallel.multihost import (host_shard_indices,
                                                    initialize_multihost)

__all__ = ["CrossDeviceLoss", "all_gather_rows", "all_reduce_sum",
           "mean_over_ranks", "data_parallel_group",
           "using_data_parallel_group", "close_group", "make_group",
           "rank_devices", "host_shard_indices", "initialize_multihost",
           "local_devices"]
