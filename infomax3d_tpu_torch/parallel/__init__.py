"""Parallelism on `torch.distributed` (port of `infomax3d_tpu/
parallel/`): data parallelism (``n_shards``: one process per shard,
losses, BatchNorm statistics and parameter updates equal to one process's
on the concatenated batch), and the edge- and node-partitioned modes
(``graph_shards``, ``node_shards``: one batch cut over the ranks of a
graph group, `edge_partition.py`, `node_partition.py`), and tensor
parallelism (``model_shards``: the sharded leaves' column shards over the
ranks of a model group, gathered whole for each forward, `tp.py`), alone
or on one (data, model) grid with ``n_shards``."""
from infomax3d_tpu_torch.parallel.collectives import (CrossDeviceLoss,
                                                      all_gather_rows,
                                                      all_reduce_sum,
                                                      gather_shards,
                                                      mean_over_ranks)
from infomax3d_tpu_torch.parallel.context import (data_parallel_group,
                                                  edge_partition_group,
                                                  model_group,
                                                  node_partition_group,
                                                  using_groups)
from infomax3d_tpu_torch.parallel.mesh import (Grid, close_group,
                                               local_devices, make_grid,
                                               make_group, rank_devices)
from infomax3d_tpu_torch.parallel.multihost import (host_shard_indices,
                                                    initialize_multihost)
from infomax3d_tpu_torch.parallel.tp import (make_tp_grid, shard_module,
                                             shard_step, tp_spec_for)

__all__ = ["CrossDeviceLoss", "all_gather_rows", "all_reduce_sum",
           "gather_shards", "mean_over_ranks", "data_parallel_group",
           "edge_partition_group", "model_group", "node_partition_group",
           "using_groups", "Grid", "close_group", "make_grid", "make_group",
           "rank_devices", "host_shard_indices", "initialize_multihost",
           "local_devices", "make_tp_grid", "shard_module", "shard_step",
           "tp_spec_for"]
