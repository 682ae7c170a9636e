from infomax3d_tpu_torch.models.pna import PNA, PNAGNN, PNALayer

__all__ = ["PNA", "PNAGNN", "PNALayer"]
