from bigdl_tpu_torch.serving.decode_engine import (DecodeConfig,
                                                   DecodeEngine,
                                                   DecodeRequest,
                                                   DecodeResult, LMAdapter,
                                                   RequestCancelledError,
                                                   Seq2SeqAdapter,
                                                   SpecConfig)
from bigdl_tpu_torch.serving.inference_model import InferenceModel
from bigdl_tpu_torch.serving.seq2seq import Seq2SeqService

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeRequest", "DecodeResult",
           "InferenceModel", "LMAdapter", "RequestCancelledError",
           "Seq2SeqAdapter", "Seq2SeqService", "SpecConfig"]
