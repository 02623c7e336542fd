from bigdl_tpu_torch.tensor.policy import (apply_precision_policy,
                                           cast_compute, get_compute_dtype,
                                           set_compute_dtype)

__all__ = ["apply_precision_policy", "cast_compute", "get_compute_dtype",
           "set_compute_dtype"]
