from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules

__all__ = ["SyntheticMolecules"]
