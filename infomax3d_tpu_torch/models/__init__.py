from infomax3d_tpu_torch.models.gin import GINConv, GNNNode, OGBGNN
from infomax3d_tpu_torch.models.net3d import (Net3D, Net3DDense,
                                              Net3DDenseLayer, Net3DLayer)
from infomax3d_tpu_torch.models.pna import PNA, PNAGNN, PNALayer

__all__ = ["GINConv", "GNNNode", "Net3D", "Net3DDense", "Net3DDenseLayer",
           "Net3DLayer", "OGBGNN", "PNA", "PNAGNN", "PNALayer"]
