"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Every wrapper dispatches on its tensors' device: CPU tensors run the plain
version (`*_reference`), CUDA tensors launch the kernel or raise — there is
no fallback.  `<wrapper>.launches` counts the kernel launches, and only
them.
"""
from infomax3d_tpu_torch.ops.kernels.edge_combine import (
    edge_combine, edge_combine_reference)
from infomax3d_tpu_torch.ops.kernels.multi_reduce import (
    multi_reduce, multi_reduce_reference)
from infomax3d_tpu_torch.ops.kernels.pna_stats import (
    pna_stats, pna_stats_reference)

WRAPPERS = {"edge_combine": edge_combine, "pna_stats": pna_stats,
            "multi_reduce": multi_reduce}

__all__ = ["WRAPPERS", "edge_combine", "edge_combine_reference",
           "multi_reduce", "multi_reduce_reference", "pna_stats",
           "pna_stats_reference"]
