from infomax3d_tpu_torch.train.precision import (cast_parameters,
                                                 resolve_compute_dtype)

__all__ = ["cast_parameters", "resolve_compute_dtype"]
