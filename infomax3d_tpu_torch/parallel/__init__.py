"""Parallelism on `torch.distributed` (port of `infomax3d_tpu/
parallel/`): data parallelism (``n_shards``: one process per shard,
losses, BatchNorm statistics and parameter updates equal to one process's
on the concatenated batch), and the edge- and node-partitioned modes
(``graph_shards``, ``node_shards``: one batch cut over the ranks of a
graph group, `edge_partition.py`, `node_partition.py`).  Tensor
parallelism is ROADMAP queue 1, item 9c."""
from infomax3d_tpu_torch.parallel.collectives import (CrossDeviceLoss,
                                                      all_gather_rows,
                                                      all_reduce_sum,
                                                      mean_over_ranks)
from infomax3d_tpu_torch.parallel.context import (data_parallel_group,
                                                  edge_partition_group,
                                                  node_partition_group,
                                                  using_groups)
from infomax3d_tpu_torch.parallel.mesh import (Grid, close_group,
                                               local_devices, make_grid,
                                               make_group, rank_devices)
from infomax3d_tpu_torch.parallel.multihost import (host_shard_indices,
                                                    initialize_multihost)

__all__ = ["CrossDeviceLoss", "all_gather_rows", "all_reduce_sum",
           "mean_over_ranks", "data_parallel_group", "edge_partition_group",
           "node_partition_group", "using_groups", "Grid", "close_group", "make_grid", "make_group",
           "rank_devices", "host_shard_indices", "initialize_multihost",
           "local_devices"]
