from infomax3d_tpu_torch.losses.contrastive import NTXent

__all__ = ["NTXent"]
