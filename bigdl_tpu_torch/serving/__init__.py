"""Serving — the port of ``bigdl_tpu.serving``: ``InferenceModel``, the
decode engine and its fleet half, ``Seq2SeqService``, and the serving
stack over them (``ServingServer``, ``HttpFrontend`` / ``HttpClient``,
the ``InputQueue`` / ``OutputQueue`` client and ``ServingPool``)."""

from bigdl_tpu_torch.serving.client import InputQueue, OutputQueue
from bigdl_tpu_torch.serving.decode_engine import (DecodeConfig,
                                                   DecodeEngine,
                                                   DecodeRequest,
                                                   DecodeResult, LMAdapter,
                                                   RequestCancelledError,
                                                   Seq2SeqAdapter,
                                                   SpecConfig)
from bigdl_tpu_torch.serving.fleet import (FleetRouter, PrefixCache,
                                           pack_handoff, unpack_handoff)
from bigdl_tpu_torch.serving.http_frontend import HttpClient, HttpFrontend
from bigdl_tpu_torch.serving.inference_model import InferenceModel
from bigdl_tpu_torch.serving.pool import ServingPool
from bigdl_tpu_torch.serving.seq2seq import Seq2SeqService
from bigdl_tpu_torch.serving.server import (DeadlineExceededError,
                                            RequestDroppedError,
                                            ServiceUnavailableError,
                                            ServingConfig, ServingServer)

__all__ = ["DeadlineExceededError", "DecodeConfig", "DecodeEngine",
           "DecodeRequest", "DecodeResult", "FleetRouter", "HttpClient",
           "HttpFrontend", "InferenceModel", "InputQueue", "LMAdapter",
           "OutputQueue", "PrefixCache", "RequestCancelledError",
           "RequestDroppedError", "Seq2SeqAdapter", "Seq2SeqService",
           "ServiceUnavailableError", "ServingConfig", "ServingPool",
           "ServingServer", "SpecConfig", "pack_handoff", "unpack_handoff"]
