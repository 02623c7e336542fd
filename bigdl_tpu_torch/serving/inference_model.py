"""InferenceModel — the port of ``bigdl_tpu.serving.inference_model``'s
autoregressive half: a model holder whose ``generate`` routes through
the paged-KV continuous decode engine, with int8 serving weights
(``weight_quant="int8"``), int8 KV pages and speculative decoding
(``decode=DecodeConfig(kv_dtype=..., speculative=SpecConfig(...))``).
(The batch-bucketed ``predict`` is not ported yet.)"""

import math
import queue
import time
from contextlib import nullcontext
from typing import List, Optional

import numpy as np

from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.serving.decode_engine import (DecodeConfig,
                                                   DecodeEngine,
                                                   DecodeRequest,
                                                   DecodeResult, LMAdapter)
from bigdl_tpu_torch.tensor.policy import apply_precision_policy


class InferenceModel:
    """Holds a ``Transformer(mode="lm")`` on ``device`` (``cuda`` unless
    the caller asks for another, e.g. ``device="cpu"``) and serves
    generation through a :class:`DecodeEngine` built from ``decode``.

    ``weight_quant="int8"`` serves a copy of the model whose matmul
    weights are int8 with per-out-column scales (4x fewer bytes at rest;
    the caller's model is left as it is, and may be dropped to free its
    float32 weights).  ``self.model`` is then that copy: each engine call
    works on a dequantized view, and :meth:`weights` lends one to other
    callers.  A
    ``decode`` config with ``speculative=SpecConfig(...)`` also builds
    the weight-sharing block-sparse draft twin at load."""

    def __init__(self, model, decode: Optional[DecodeConfig] = None,
                 device=None, weight_quant: Optional[str] = None):
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant {weight_quant!r}: "
                             "None | 'int8'")
        if weight_quant is not None and decode is None:
            raise ValueError("weight_quant= applies to the decode engine's "
                             "weights; pass decode=DecodeConfig(...)")
        self.device = resolve_device(device)
        apply_precision_policy()
        self.model = model.to(self.device).eval()
        self.weight_quant = weight_quant
        self.decode_engine = None
        if decode is not None:
            if getattr(model, "mode", None) != "lm":
                raise ValueError("decode= needs an LM-mode Transformer")
            self.decode_engine = DecodeEngine(
                LMAdapter(self.model, cap=decode.cap,
                          weight_quant=weight_quant), decode)
            self.model = self.decode_engine.adapter.model

    def weights(self):
        """Context in which ``self.model`` holds float32 weights (their
        dequantized view under ``weight_quant="int8"``)."""
        if self.decode_engine is None:
            return nullcontext()
        return self.decode_engine.adapter.weights()

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

    def warmup(self) -> "InferenceModel":
        """Build the kernels and run the engine's warm calls before
        traffic."""
        if self.decode_engine is not None:
            self.decode_engine.warmup()
        return self

    def stop(self) -> None:
        """Stop the decode engine's thread (pending requests fail)."""
        if self.decode_engine is not None:
            self.decode_engine.stop()
