"""InferenceModel — the port of ``bigdl_tpu.serving.inference_model``: a
model holder whose ``predict`` serves batches padded to a closed set of
batch buckets, and whose ``generate`` routes through the paged-KV
continuous decode engine, with int8 serving weights
(``weight_quant="int8"``), int8 KV pages and speculative decoding
(``decode=DecodeConfig(kv_dtype=..., speculative=SpecConfig(...))``),
and model-sharded serving over a declarative layout (``layout=``)."""

import math
import queue
import time
from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.keras.engine import Model as KerasModel
from bigdl_tpu_torch.nn.module import Container
from bigdl_tpu_torch.nn.quantized import Int8Weights, quantize
from bigdl_tpu_torch.ops.common import DEVICE_GATE, resolve_device
from bigdl_tpu_torch.parallel import local_ops
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
    ``Container``: Sequential, LeNet, ResNet) or a keras ``Model`` is
    replaced by :func:`~bigdl_tpu_torch.nn.quantized.quantize`'s copy,
    whose ``Linear`` / ``Conv2D`` leaves (a keras model's node layers)
    run the int8 matmul kernel; the caller's model stays as and where it
    is.  Any other model (the
    Transformer LM) is moved to ``device`` and served from a copy whose
    matmul weights are int8 at rest with per-out-column scales
    (``Int8Weights``): each call works on a dequantized view, and
    :meth:`weights` lends one to other callers; the caller's model keeps
    its weights.

    A ``decode`` config serves an LM-mode Transformer's ``generate``
    through a :class:`DecodeEngine`; with ``speculative=SpecConfig(...)``
    it also builds the weight-sharing block-sparse draft twin at load.
    On CUDA the engine's calls replay CUDA graphs that :meth:`warmup`
    captures (``DecodeConfig.cuda_graphs``); without a warmup each graph
    is captured at its first call.

    ``layout`` serves model-sharded: a ``parallelism=`` combo string
    (``"tp:2"``, ``"fsdp:2,tp:2"``) or a ``ResolvedLayout``.  The
    model's table places every parameter as a DTensor on the layout's
    mesh (``ResolvedLayout.shard_params``, audited at load); every rank
    of the world calls :meth:`predict` with the same (replicated) batch
    and gets the whole output, bucket for bucket as without a layout.
    The weights are placed first and then quantized, as in the JAX
    package: under ``weight_quant="int8"`` the int8 tensors and their
    scales are DTensors with the float weights' placements (an int8
    twin's kernel runs on each rank's output columns, ``parallel.
    local_ops.int8_layer``).  With ``decode=`` the engine's adapter runs
    over the placed (and quantized) model, each rank with a whole-head
    KV pool (``_AdapterBase``); every rank must call :meth:`generate`
    with the same prompts.

    ``predict_fn`` serves any callable instead of a model:
    :meth:`predict` returns ``np.asarray(predict_fn(x))`` for the whole
    batch, unbucketed, on the caller's thread (grad mode and devices are
    the callable's own concern); it takes no ``layout``,
    ``weight_quant`` or ``decode``."""

    def __init__(self, model=None, decode: Optional[DecodeConfig] = None,
                 device=None, weight_quant: Optional[str] = None,
                 batch_buckets: Sequence[int] = (1, 4, 16, 64, 256),
                 layout=None, predict_fn: Optional[Callable] = None):
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant {weight_quant!r}: "
                             "None | 'int8'")
        self.buckets = tuple(sorted(int(b) for b in batch_buckets))
        self.decode_engine = None
        self._custom = predict_fn
        if predict_fn is not None:
            if layout is not None:
                raise ValueError("layout= applies to (model, variables) "
                                 "serving, not a custom predict_fn")
            if weight_quant is not None:
                raise ValueError("weight_quant= applies to (model, "
                                 "variables) serving, not a custom "
                                 "predict_fn")
            if decode is not None:
                raise ValueError("decode= needs an LM-mode Transformer "
                                 "(model, variables), not a custom "
                                 "predict_fn")
            self.model = model
            self.weight_quant = None
            self.layout = None
            self._w8 = None
            return
        if model is None:
            raise ValueError("need a model or predict_fn")
        if decode is not None and getattr(model, "mode", None) != "lm":
            raise ValueError("decode= needs an LM-mode Transformer; for "
                             "translation models use "
                             "Seq2SeqService(continuous=True)")
        self.device = resolve_device(device)
        apply_precision_policy()
        self.weight_quant = weight_quant
        self._w8 = None
        layered = isinstance(model, (Container, KerasModel))
        self.layout = None
        if layout is not None:
            from bigdl_tpu_torch.parallel.mesh_policy import (
                ResolvedLayout, mesh_and_layout)

            self.layout = (layout if isinstance(layout, ResolvedLayout)
                           else mesh_and_layout(str(layout), self.device))
            # placed first, then quantized (JAX's order): the int8
            # tensors and their scales keep the float weights' placements
            self.layout.shard_params(model.to(self.device))
        if weight_quant is not None and layered:
            model = quantize(model)
        self.model = model.to(self.device).eval()
        if weight_quant is not None and not layered and decode is None:
            self._w8 = Int8Weights(self.model)
            self.model = self._w8.module
        if decode is not None:
            self.decode_engine = DecodeEngine(
                LMAdapter(self.model, cap=decode.cap,
                          weight_quant=weight_quant, layout=self.layout),
                decode)
            self.model = self.decode_engine.adapter.model

    @staticmethod
    def load(path: str, model, **kwargs) -> "InferenceModel":
        """Serve ``model`` with the weights saved at ``path`` by either
        package's ``save_model``; ``kwargs`` go to the constructor."""
        from bigdl_tpu_torch.utils.convert import load_jax_variables
        from bigdl_tpu_torch.utils.serializer import load_model

        return InferenceModel(load_jax_variables(model, load_model(path)),
                              **kwargs)

    @staticmethod
    def load_tf(path: str, **kwargs) -> "InferenceModel":
        raise ValueError("InferenceModel.load_tf: the TF graph import is "
                         "not ported yet (ROADMAP A.6.11)")

    @staticmethod
    def load_caffe(path: str, **kwargs) -> "InferenceModel":
        raise ValueError("InferenceModel.load_caffe: the Caffe import is "
                         "not ported yet (ROADMAP A.6.11)")

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
        if self._custom is not None:
            return np.asarray(self._custom(x))
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
        # grad mode is per thread: a server's predict thread sets its own
        with DEVICE_GATE.work(self.device), torch.no_grad(), \
                self.weights(), self._replicated():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            out = local_ops.replicated(self.model(xt))
            return out[:n].cpu().numpy()

    def _replicated(self):
        """On a layout, plain tensors (the batch) are replicated ones."""
        if self.layout is None:
            return nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()

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
        sequences) through the continuous decode engine, queued together
        (one batch, the same schedule from run to run).  Greedy by
        default; ``temperature/top_k/top_p`` sample with the per-request
        ``seeds`` (default: the prompt index).  Returns a list of
        generated-token arrays (EOS included when hit), or the
        :class:`DecodeResult` of each request with
        ``return_results=True``."""
        engine = self._engine()
        deadline_t = (time.time() + deadline_s if deadline_s is not None
                      else math.inf)
        reqs = engine.submit_many([DecodeRequest(
            tokens=np.asarray(p, np.int32), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            seed=int(seeds[i]) if seeds is not None else i,
            deadline_t=deadline_t)
            for i, p in enumerate(prompts)])
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
        closed program set (captured as CUDA graphs on the card).  A
        custom ``predict_fn`` has nothing to warm."""
        if self._custom is not None:
            return self
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
