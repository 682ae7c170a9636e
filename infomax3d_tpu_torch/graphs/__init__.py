from infomax3d_tpu_torch.graphs.batch import (BucketSpec, GraphBatch,
                                              batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import (DenseBatch, dense_batch,
                                              to_dense_batch)

__all__ = ["BucketSpec", "DenseBatch", "GraphBatch", "batch_graphs",
           "bucket_for", "dense_batch", "to_dense_batch", "to_graph_batch"]
