from bigdl_tpu_torch.utils.convert import (export_keras_variables,
                                           export_params, export_variables,
                                           load_jax_keras_variables,
                                           load_jax_params,
                                           load_jax_variables,
                                           load_keras_variables)

__all__ = ["export_keras_variables", "export_params", "export_variables",
           "load_jax_keras_variables", "load_jax_params",
           "load_jax_variables", "load_keras_variables"]
