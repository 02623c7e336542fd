from bigdl_tpu_torch.utils.convert import export_params, load_jax_params

__all__ = ["export_params", "load_jax_params"]
