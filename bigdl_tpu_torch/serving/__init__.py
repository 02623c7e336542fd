from bigdl_tpu_torch.serving.decode_engine import (DecodeConfig,
                                                   DecodeEngine,
                                                   DecodeRequest,
                                                   DecodeResult, LMAdapter,
                                                   RequestCancelledError,
                                                   SpecConfig)
from bigdl_tpu_torch.serving.inference_model import InferenceModel

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeRequest", "DecodeResult",
           "InferenceModel", "LMAdapter", "RequestCancelledError",
           "SpecConfig"]
