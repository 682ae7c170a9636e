from infomax3d_tpu_torch.train.precision import (cast_batch, cast_parameters,
                                                 compute_params,
                                                 resolve_compute_dtype)

__all__ = ["cast_batch", "cast_parameters", "compute_params",
           "resolve_compute_dtype"]
