from infomax3d_tpu_torch.models.net3d import Net3DDense, Net3DDenseLayer
from infomax3d_tpu_torch.models.pna import PNA, PNAGNN, PNALayer

__all__ = ["Net3DDense", "Net3DDenseLayer", "PNA", "PNAGNN", "PNALayer"]
