from infomax3d_tpu_torch.graphs.batch import (BucketSpec, GraphBatch,
                                              batch_graphs, bucket_for,
                                              to_graph_batch)

__all__ = ["BucketSpec", "GraphBatch", "batch_graphs", "bucket_for",
           "to_graph_batch"]
