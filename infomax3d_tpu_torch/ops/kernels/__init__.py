"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Every wrapper dispatches on its tensors' device: CPU tensors run the plain
version (`*_reference`), CUDA tensors launch the kernel or raise — there is
no fallback.  The forward wrappers are `torch.autograd.Function`s on both
devices, whose backwards are the backward wrappers (`pair_segment_sum`,
`pna_stats_bwd`) or, for `multi_reduce` and `csr_sum`, plain PyTorch.
`snd_segment_sum` is the backward of the sender gather (`ops/segment.py::
take_rows`), `csr_segment_sum` that of the receiver gather (`ops/
segment.py::take_rows_recv`).  A launch that gets a tensor requiring grad
outside its Function raises.  `<wrapper>.launches` counts the kernel
launches, and only them.
"""
from infomax3d_tpu_torch.ops.kernels.csr_segment_sum import (
    csr_segment_sum, csr_segment_sum_reference)
from infomax3d_tpu_torch.ops.kernels.csr_sum import (csr_mean, csr_sum,
                                                     csr_sum_reference)
from infomax3d_tpu_torch.ops.kernels.edge_combine import (
    edge_combine, edge_combine_reference)
from infomax3d_tpu_torch.ops.kernels.multi_reduce import (
    multi_reduce, multi_reduce_reference)
from infomax3d_tpu_torch.ops.kernels.pair_segment_sum import (
    pair_segment_sum, pair_segment_sum_reference)
from infomax3d_tpu_torch.ops.kernels.pna_stats import (
    pna_stats, pna_stats_reference)
from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import (
    pna_stats_bwd, pna_stats_bwd_reference)
from infomax3d_tpu_torch.ops.kernels.snd_segment_sum import (
    snd_segment_sum, snd_segment_sum_reference)

WRAPPERS = {"edge_combine": edge_combine, "pna_stats": pna_stats,
            "multi_reduce": multi_reduce,
            "pair_segment_sum": pair_segment_sum,
            "pna_stats_bwd": pna_stats_bwd, "csr_sum": csr_sum,
            "snd_segment_sum": snd_segment_sum,
            "csr_segment_sum": csr_segment_sum}

__all__ = ["WRAPPERS", "csr_mean", "csr_segment_sum",
           "csr_segment_sum_reference", "csr_sum", "csr_sum_reference",
           "edge_combine", "edge_combine_reference", "multi_reduce",
           "multi_reduce_reference", "pair_segment_sum",
           "pair_segment_sum_reference", "pna_stats", "pna_stats_bwd",
           "pna_stats_bwd_reference", "pna_stats_reference",
           "snd_segment_sum", "snd_segment_sum_reference"]
