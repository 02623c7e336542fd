"""InferenceModel — the port of ``bigdl_tpu.serving.inference_model``'s
autoregressive half: a model holder whose ``generate`` routes through
the paged-KV continuous decode engine.  (The batch-bucketed ``predict``
is not ported yet.)"""

import math
import queue
import time
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
    generation through a :class:`DecodeEngine` built from ``decode``."""

    def __init__(self, model, decode: Optional[DecodeConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        apply_precision_policy()
        self.model = model.to(self.device).eval()
        self.decode_engine = None
        if decode is not None:
            if getattr(model, "mode", None) != "lm":
                raise ValueError("decode= needs an LM-mode Transformer")
            self.decode_engine = DecodeEngine(
                LMAdapter(self.model, cap=decode.cap), decode)

    def _engine(self) -> DecodeEngine:
        if self.decode_engine is None:
            raise ValueError("this InferenceModel has no decode engine; "
                             "construct it with decode=DecodeConfig(...)")
        return self.decode_engine

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0,
                 deadline_s: Optional[float] = None,
                 return_results: bool = False):
        """Generate continuations for ``prompts`` (a list of int token
        sequences) through the continuous decode engine.  Greedy only
        for now (``temperature > 0`` is refused).  Returns a list of
        generated-token arrays (EOS included when hit), or the
        :class:`DecodeResult` of each request with
        ``return_results=True``."""
        engine = self._engine()
        deadline_t = (time.time() + deadline_s if deadline_s is not None
                      else math.inf)
        reqs = [engine.submit(DecodeRequest(
            tokens=np.asarray(p, np.int32), max_new_tokens=max_new_tokens,
            temperature=temperature, deadline_t=deadline_t))
            for p in prompts]
        results: List[DecodeResult] = [r.wait(timeout=300.0) for r in reqs]
        return results if return_results else [r.tokens for r in results]

    def generate_stream(self, prompt, max_new_tokens: Optional[int] = None,
                        temperature: float = 0.0,
                        deadline_s: Optional[float] = None):
        """Streaming generate: yields token ids as they decode."""
        engine = self._engine()
        q: queue.Queue = queue.Queue()
        done = object()
        req = DecodeRequest(
            tokens=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens, temperature=temperature,
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
