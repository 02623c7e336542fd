from bigdl_tpu_torch.utils.convert import (export_params, export_variables,
                                           load_jax_keras_variables,
                                           load_jax_params,
                                           load_jax_variables)

__all__ = ["export_params", "export_variables", "load_jax_keras_variables",
           "load_jax_params", "load_jax_variables"]
