"""InferenceModel — the port of ``bigdl_tpu.serving.inference_model``: a
model holder whose ``predict`` serves batches padded to a closed set of
batch buckets, and whose ``generate`` routes through the paged-KV
continuous decode engine, with int8 serving weights
(``weight_quant="int8"``), int8 KV pages and speculative decoding
(``decode=DecodeConfig(kv_dtype=..., speculative=SpecConfig(...))``)."""

import math
import queue
import time
from contextlib import nullcontext
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Container
from bigdl_tpu_torch.nn.quantized import (Int8Weights, quantize,
                                          refuse_keras_quantization)
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.serving.decode_engine import (DecodeConfig,
                                                   DecodeEngine,
                                                   DecodeRequest,
                                                   DecodeResult, LMAdapter)
from bigdl_tpu_torch.tensor.policy import apply_precision_policy


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class InferenceModel:
    """Holds a model on ``device`` (``cuda`` unless the caller asks for
    another, e.g. ``device="cpu"``) in eval mode.

    :meth:`predict` runs a batch padded up to the next of
    ``batch_buckets`` (by repeating its last row) and chunks a batch
    larger than the largest bucket, so the model only ever sees the
    bucket shapes.

    A keras ``Model`` (e.g. the ``"fused"`` rebuild of
    ``utils.intermediate``) is served by :meth:`predict` as any model.

    ``weight_quant="int8"`` serves int8 weights.  A layered model (a
    ``Container``: Sequential, LeNet, ResNet) is replaced by
    :func:`~bigdl_tpu_torch.nn.quantized.quantize`'s copy, whose
    ``Linear`` / ``Conv2D`` leaves run the int8 matmul kernel; the
    caller's model stays as and where it is.  Any other model (the
    Transformer LM) is moved to ``device`` and served from a copy whose
    matmul weights are int8 at rest with per-out-column scales
    (``Int8Weights``): each call works on a dequantized view, and
    :meth:`weights` lends one to other callers; the caller's model keeps
    its weights.  A keras ``Model`` is refused: the JAX package swaps its
    nodes' layers, which is not ported yet (ROADMAP item 7.1).

    A ``decode`` config serves an LM-mode Transformer's ``generate``
    through a :class:`DecodeEngine`; with ``speculative=SpecConfig(...)``
    it also builds the weight-sharing block-sparse draft twin at load."""

    def __init__(self, model, decode: Optional[DecodeConfig] = None,
                 device=None, weight_quant: Optional[str] = None,
                 batch_buckets: Sequence[int] = (1, 4, 16, 64, 256)):
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant {weight_quant!r}: "
                             "None | 'int8'")
        if decode is not None and getattr(model, "mode", None) != "lm":
            raise ValueError("decode= needs an LM-mode Transformer")
        self.device = resolve_device(device)
        apply_precision_policy()
        self.weight_quant = weight_quant
        self.buckets = tuple(sorted(int(b) for b in batch_buckets))
        self._w8 = None
        self.decode_engine = None
        if weight_quant is not None:
            refuse_keras_quantization(model, "weight_quant='int8'")
        layered = isinstance(model, Container)
        if weight_quant is not None and layered:
            model = quantize(model)
        self.model = model.to(self.device).eval()
        if weight_quant is not None and not layered and decode is None:
            self._w8 = Int8Weights(self.model)
            self.model = self._w8.module
        if decode is not None:
            self.decode_engine = DecodeEngine(
                LMAdapter(self.model, cap=decode.cap,
                          weight_quant=weight_quant), decode)
            self.model = self.decode_engine.adapter.model

    def weights(self):
        """Context in which ``self.model`` holds float32 weights (their
        dequantized view when they are int8 at rest)."""
        if self.decode_engine is not None:
            return self.decode_engine.adapter.weights()
        return self._w8.view() if self._w8 is not None else nullcontext()

    def predict(self, x) -> np.ndarray:
        """The model's output for the batch ``x`` (numpy or a tensor; the
        first dim is the batch), as a numpy array."""
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        cap = self.buckets[-1]
        if x.shape[0] > cap:
            return np.concatenate([self._predict_bucketed(x[i:i + cap])
                                   for i in range(0, x.shape[0], cap)])
        return self._predict_bucketed(x)

    def _predict_bucketed(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        b = _bucket(n, self.buckets)
        if n < b:
            x = np.concatenate([x, np.repeat(x[-1:], b - n, axis=0)])
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with torch.no_grad(), self.weights():
            out = self.model(xt)
        return out[:n].cpu().numpy()

    def _engine(self) -> DecodeEngine:
        if self.decode_engine is None:
            raise ValueError("this InferenceModel has no decode engine; "
                             "construct it with decode=DecodeConfig(...)")
        return self.decode_engine

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seeds=None,
                 deadline_s: Optional[float] = None,
                 return_results: bool = False):
        """Generate continuations for ``prompts`` (a list of int token
        sequences) through the continuous decode engine.  Greedy by
        default; ``temperature/top_k/top_p`` sample with the per-request
        ``seeds`` (default: the prompt index).  Returns a list of
        generated-token arrays (EOS included when hit), or the
        :class:`DecodeResult` of each request with
        ``return_results=True``."""
        engine = self._engine()
        deadline_t = (time.time() + deadline_s if deadline_s is not None
                      else math.inf)
        reqs = [engine.submit(DecodeRequest(
            tokens=np.asarray(p, np.int32), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            seed=int(seeds[i]) if seeds is not None else i,
            deadline_t=deadline_t))
            for i, p in enumerate(prompts)]
        results: List[DecodeResult] = [r.wait(timeout=300.0) for r in reqs]
        return results if return_results else [r.tokens for r in results]

    def generate_stream(self, prompt, max_new_tokens: Optional[int] = None,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0, seed: int = 0,
                        deadline_s: Optional[float] = None):
        """Streaming generate: yields token ids as they decode.  One
        request; keyword args as :meth:`generate`."""
        engine = self._engine()
        q: queue.Queue = queue.Queue()
        done = object()
        req = DecodeRequest(
            tokens=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed,
            deadline_t=(time.time() + deadline_s
                        if deadline_s is not None else math.inf),
            on_token=lambda rid, tok, idx: q.put(tok),
            on_done=lambda r: q.put(done))
        engine.submit(req)
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        if req.error is not None:
            raise req.error

    def warmup(self, sample=None) -> "InferenceModel":
        """Before traffic: one predict per bucket from ``sample`` (one
        example, with or without a batch dim), and the decode engine's
        warm calls."""
        if sample is not None:
            row = np.asarray(sample)
            row = row[:1] if row.ndim >= 2 else row[None]
            for b in self.buckets:
                self._predict_bucketed(np.repeat(row, b, axis=0))
        if self.decode_engine is not None:
            self.decode_engine.warmup()
        return self

    def stop(self) -> None:
        """Stop the decode engine's thread (pending requests fail)."""
        if self.decode_engine is not None:
            self.decode_engine.stop()
