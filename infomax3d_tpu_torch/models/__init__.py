from infomax3d_tpu_torch.models.gin import GINConv, GNNNode, OGBGNN
from infomax3d_tpu_torch.models.net3d import Net3DDense, Net3DDenseLayer
from infomax3d_tpu_torch.models.pna import PNA, PNAGNN, PNALayer

__all__ = ["GINConv", "GNNNode", "Net3DDense", "Net3DDenseLayer", "OGBGNN",
           "PNA", "PNAGNN", "PNALayer"]
