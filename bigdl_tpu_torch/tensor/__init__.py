from bigdl_tpu_torch.tensor.policy import (apply_precision_policy,
                                           cast_compute, compute_dtype,
                                           get_compute_dtype, matmul_f32,
                                           matmul_promote, set_compute_dtype)

__all__ = ["apply_precision_policy", "cast_compute", "compute_dtype",
           "get_compute_dtype", "matmul_f32", "matmul_promote",
           "set_compute_dtype"]
